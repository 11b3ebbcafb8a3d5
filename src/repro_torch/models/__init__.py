"""Model zoo: every assigned architecture family (the decoder-only
transformers, zamba2, the xLSTM stack, the encoder-decoder) in PyTorch;
port of ``repro.models``."""

from .model_zoo import Model, build_model, count_params_analytic

__all__ = ["Model", "build_model", "count_params_analytic"]
