"""Ported layer configs; importing this package registers them for serde."""
from deeplearning4j_tpu_torch.nn.layers.attention import (
    EmbeddingSequenceLayer, LayerNormLayer, MoEFeedForward, MultiHeadAttention,
    PositionalEmbeddingLayer, TransformerBlock, dot_product_attention, rope,
)
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    CnnLossLayer, Convolution1DLayer, ConvolutionLayer, Cropping1D,
    Cropping2D, Deconvolution2D, DepthwiseConvolution2D, GlobalPoolingLayer,
    LocallyConnected1D, LocallyConnected2D, SeparableConvolution2D,
    SpaceToBatchLayer, SpaceToDepthLayer, Subsampling1DLayer,
    SubsamplingLayer, Upsampling1D, Upsampling2D, ZeroPadding1DLayer,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.layers.feedforward import (
    ActivationLayer, AutoEncoder, CenterLossOutputLayer, DenseLayer,
    DropoutLayer, ElementWiseMultiplicationLayer, EmbeddingLayer, LossLayer,
    OutputLayer, PermuteLayer, RepeatVector, ReshapeLayer,
)
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNormalization, LocalResponseNormalization,
)
from deeplearning4j_tpu_torch.nn.layers.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    GRU, LSTM, Bidirectional, GravesBidirectionalLSTM, GravesLSTM,
    LastTimeStep, MaskZeroLayer, RnnLossLayer, RnnOutputLayer, SimpleRnn,
)
from deeplearning4j_tpu_torch.nn.layers.samediff import (
    FrozenLayerWrapper, SameDiffLayer,
)
from deeplearning4j_tpu_torch.nn.layers.variational import (
    VariationalAutoencoder,
)

__all__ = [
    "ActivationLayer", "AutoEncoder", "BatchNormalization", "Bidirectional",
    "CenterLossOutputLayer", "CnnLossLayer", "Convolution1DLayer",
    "ConvolutionLayer", "Cropping1D", "Cropping2D", "Deconvolution2D",
    "DenseLayer", "DepthwiseConvolution2D", "DropoutLayer",
    "ElementWiseMultiplicationLayer", "EmbeddingLayer",
    "EmbeddingSequenceLayer", "FrozenLayerWrapper", "GRU",
    "GlobalPoolingLayer", "GravesBidirectionalLSTM", "GravesLSTM", "LSTM",
    "LastTimeStep", "LayerNormLayer",
    "LocalResponseNormalization", "LocallyConnected1D", "LocallyConnected2D",
    "LossLayer", "MaskZeroLayer", "MoEFeedForward", "MultiHeadAttention",
    "OutputLayer", "PermuteLayer", "PositionalEmbeddingLayer",
    "RepeatVector", "ReshapeLayer", "RnnLossLayer", "RnnOutputLayer",
    "SameDiffLayer", "SeparableConvolution2D", "SimpleRnn",
    "SpaceToBatchLayer", "SpaceToDepthLayer", "Subsampling1DLayer",
    "SubsamplingLayer", "TransformerBlock", "Upsampling1D", "Upsampling2D",
    "VariationalAutoencoder", "Yolo2OutputLayer", "ZeroPadding1DLayer",
    "ZeroPaddingLayer", "dot_product_attention", "rope",
]
