"""Model zoo of the port: the decode-path LMs (transformer and LSTM),
the BERT encoder family of the batch-serving and pretraining paths, the
SSD detectors and the vision zoo (LeNet-5, the ResNet v1 family,
Inception v3)."""
from . import bert, decoder, ssd, vision
from .bert import (BERTForPretrain, BERTModel, bert_12_768_12,
                   bert_24_1024_16, get_bert)
from .decoder import LSTMLM, TransformerLM, lstm_lm, transformer_lm
from .ssd import SSD, ssd_300_resnet34_v1, ssd_512_resnet50_v1

__all__ = ["bert", "decoder", "ssd", "vision", "BERTForPretrain",
           "BERTModel", "bert_12_768_12", "bert_24_1024_16", "get_bert",
           "get_model", "TransformerLM", "LSTMLM", "transformer_lm",
           "lstm_lm", "SSD", "ssd_512_resnet50_v1", "ssd_300_resnet34_v1"]

_SSD_MODELS = {"ssd_512_resnet50_v1": ssd_512_resnet50_v1,
               "ssd_300_resnet34_v1": ssd_300_resnet34_v1}

_LM_MODELS = {"transformer_lm": transformer_lm, "lstm_lm": lstm_lm}


def get_model(name, **kwargs):
    """A zoo model by name: the BERT sizes (``get_bert``), the SSD
    detectors (``ssd_512_resnet50_v1``, ``ssd_300_resnet34_v1``), the
    decode LMs (``transformer_lm``, ``lstm_lm``) or a vision model
    (``vision.get_model``)."""
    if name in bert._BERT_SPECS:
        return get_bert(name, **kwargs)
    if name in _SSD_MODELS:
        return _SSD_MODELS[name](**kwargs)
    if name in _LM_MODELS:
        return _LM_MODELS[name](**kwargs)
    return vision.get_model(name, **kwargs)
