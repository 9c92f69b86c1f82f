"""The model zoo and the transformer LM (the JAX package's `models/`).

The reference's names are exported lazily (`util/lazy.py`): this
package imports none of its submodules eagerly.
"""
from deeplearning4j_tpu_torch.util.lazy import lazy_exports

_EXPORTS = {
    **dict.fromkeys((
        "ZooModel", "LeNet", "SimpleCNN", "AlexNet", "VGG16", "VGG19",
        "ResNet50", "GoogLeNet", "Darknet19", "TinyYOLO", "YOLO2",
        "TextGenerationLSTM", "InceptionResNetV1", "FaceNetNN4Small2",
        "UNet", "model_by_name", "zoo_models"), "zoo"),
    **dict.fromkeys(("TransformerLM", "TransformerLMMoE"), "transformer"),
}
__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, globals(), _EXPORTS)
