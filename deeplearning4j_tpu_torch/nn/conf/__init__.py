from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, LayerConf, register_layer, layer_from_dict, layer_to_dict,
)
from deeplearning4j_tpu_torch.nn.conf.network import (
    ComputationGraphConfiguration, GraphBuilder, MultiLayerConfiguration,
    NeuralNetConfiguration, VertexDef,
)

__all__ = [
    "InputType", "LayerConf", "register_layer", "layer_from_dict",
    "layer_to_dict", "MultiLayerConfiguration", "NeuralNetConfiguration",
    "ComputationGraphConfiguration", "GraphBuilder", "VertexDef",
]
