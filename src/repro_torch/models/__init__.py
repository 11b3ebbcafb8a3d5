"""Model zoo: the decoder-only transformer family (dense, GQA/MQA, VLM
stub, MoE, MLA) in PyTorch; port of ``repro.models``."""

from .model_zoo import Model, build_model, count_params_analytic

__all__ = ["Model", "build_model", "count_params_analytic"]
