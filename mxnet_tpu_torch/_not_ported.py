"""The JAX package's public names that the port does not have yet, each
with the ROADMAP item that ports it.

Four tables, one for each of ``mx``, ``mx.gluon``, ``mx.gluon.nn`` and
``mx.npx``, written out by hand from the JAX modules' ``__all__`` and
public names (the port never imports that package).  Each module's
``__getattr__`` (:func:`module_getattr`) raises :class:`MXNetError`
naming the item for a name in its table, as ``mx.np`` does for its
own; a name that neither package has stays an ``AttributeError``.  A
name leaves its table when its item ports it.

Items (ROADMAP.md, "A. Modules to port"): A6d is ``npx``'s operators,
the device names, array mode, ``gluon.Parameter`` and ``gluon.utils``;
A6f int8 serving and the graph lint; A6g convolution and pooling of
other ranks; A6h the rest (``mx.nd``, symbols and export, ``io``,
control flow, ``probability``, ``contrib``, the runtime modules).
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict

from .base import MXNetError

__all__ = ["MX", "GLUON", "GLUON_NN", "NPX", "module_getattr"]

_A6D = "ROADMAP A6d"
_A6G = "ROADMAP A6g"
_A6H = "ROADMAP A6h"


def _table(d6: str = "", g6: str = "", h6: str = "") -> Dict[str, str]:
    out = {n: _A6D for n in d6.split()}
    out.update({n: _A6G for n in g6.split()})
    out.update({n: _A6H for n in h6.split()})
    return out


MX = _table(
    d6="""Context cpu cpu_pinned current_context device gpu num_gpus tpu
          num_tpus set_np reset_np use_np is_np_array is_np_shape np_shape
          util dlpack""",
    h6="""AttrScope attribute callback contrib error executor image img io
          libinfo log misc model monitor name nd NDArray notebook operator
          recordio registry runtime storage sym symbol visualization
          viz""")

GLUON = _table(
    d6="Parameter Constant utils split_and_load split_data clip_global_norm",
    h6="SymbolBlock probability contrib")

GLUON_NN = _table(
    g6="""Conv1D Conv3D Conv1DTranspose Conv3DTranspose MaxPool1D MaxPool3D
          AvgPool1D AvgPool3D GlobalMaxPool1D GlobalMaxPool3D
          GlobalAvgPool1D GlobalAvgPool3D PixelShuffle1D PixelShuffle3D
          DeformableConvolution ModulatedDeformableConvolution""")

NPX = _table(
    d6="""all_finite arange_like batch_dot bernoulli boolean_mask
          broadcast_like clip_by_global_norm col2im cpu current_context
          depth_to_space digamma div_sqrt_dim dynamic_reshape embedding erf
          erfinv from_dlpack from_numpy fully_connected gamma gammaln
          gather_nd gpu index_add index_array index_copy index_update
          is_np_array khatri_rao l2_normalization load log_softmax lrn
          masked_log_softmax masked_softmax multi_all_finite multi_sum_sq
          next_key normal_n num_gpus num_tpus one_hot pick quadratic random
          relu reset_np reshape_like sample_unique_zipfian save savez
          scatter_nd seed sequence_last sequence_mask sequence_reverse
          set_np shape_array sigmoid slice_like smooth_l1 softmax
          softmax_cross_entropy space_to_depth to_dlpack_for_read
          to_dlpack_for_write topk tpu uniform_n unique_padded upsampling
          waitall""",
    g6="""adaptive_avg_pool1d adaptive_avg_pool3d adaptive_max_pool2d
          deformable_convolution""",
    h6="""NDArray autograd bilinear_sampler cache_append cache_page_copy
          call cond count_sketch dequantize_kv edge_id flash_attention_decode
          foreach getnnz grid_generator hawkesll image
          interleaved_matmul_encdec_qk interleaved_matmul_encdec_valatt
          interleaved_matmul_selfatt_qk interleaved_matmul_selfatt_valatt
          invoke quantize_kv roi_pooling rroi_align sldwin_atten_context
          sldwin_atten_mask_like sldwin_atten_score spatial_transformer
          while_loop wrap_op""")
# the JAX npx module's own imports: the port has no JAX, so they have no
# counterpart (a recorded difference, as mx.np's)
NPX.update({"jax": "ROADMAP C, the port has no JAX",
            "jnp": "ROADMAP C, the port has no JAX"})


def module_getattr(package: str, label: str, table: Dict[str, str],
                   lazy=()) -> Callable[[str], object]:
    """The ``__getattr__`` of ``package`` (known to users as ``label``,
    e.g. ``mx.npx``): a name of ``table`` raises :class:`MXNetError`
    naming its item; a name in ``lazy`` imports the submodule of that
    name on first use."""

    def __getattr__(name: str):
        if name in lazy:
            return importlib.import_module(f"{package}.{name}")
        if name in table:
            raise MXNetError(f"{label}.{name} is not ported yet; "
                             f"{table[name]}")
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    return __getattr__
