"""Model zoo of the port (only ported models are listed)."""

from theanompi_tpu_torch.models.contract import Model, Recipe, softmax_cross_entropy  # noqa: F401

# short name -> (module path, class name); imported lazily
MODEL_REGISTRY = {
    "cifar10": ("theanompi_tpu_torch.models.cifar10", "Cifar10_model"),
    "wrn": ("theanompi_tpu_torch.models.model_zoo.wrn", "WRN"),
    "wrn_16_4": ("theanompi_tpu_torch.models.model_zoo.wrn", "WRN_16_4"),
    "alexnet": ("theanompi_tpu_torch.models.alex_net", "AlexNet"),
    "googlenet": ("theanompi_tpu_torch.models.googlenet", "GoogLeNet"),
    "vgg16": ("theanompi_tpu_torch.models.model_zoo.vgg", "VGG16"),
    "resnet50": ("theanompi_tpu_torch.models.model_zoo.resnet50", "ResNet50"),
    "transformer_lm": ("theanompi_tpu_torch.models.lm", "TransformerLMModel"),
    "transformer_lm_136m": ("theanompi_tpu_torch.models.lm", "TransformerLM_136M"),
}
