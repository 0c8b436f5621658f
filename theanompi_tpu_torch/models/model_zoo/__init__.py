"""The larger models of the zoo: Wide-ResNet (``wrn``), ResNet-50
(``resnet50``) and VGG16 (``vgg``).

Port of ``theanompi_tpu/models/model_zoo/``: the same architectures,
parameter trees and training recipes, model for model, over
:mod:`theanompi_tpu_torch.nn`. These are the first models of the port
that carry BatchNorm state (WRN and ResNet-50).
"""
