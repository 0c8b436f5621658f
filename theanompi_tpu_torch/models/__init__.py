"""Model zoo of the port (only ported models are listed)."""

from theanompi_tpu_torch.models.contract import Model, Recipe, softmax_cross_entropy  # noqa: F401

# short name -> (module path, class name); imported lazily
MODEL_REGISTRY = {
    "alexnet": ("theanompi_tpu_torch.models.alex_net", "AlexNet"),
    "googlenet": ("theanompi_tpu_torch.models.googlenet", "GoogLeNet"),
    "transformer_lm": ("theanompi_tpu_torch.models.lm", "TransformerLMModel"),
    "transformer_lm_136m": ("theanompi_tpu_torch.models.lm", "TransformerLM_136M"),
}
