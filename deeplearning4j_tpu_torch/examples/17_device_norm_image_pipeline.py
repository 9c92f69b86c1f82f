"""Device-side normalization: the image input pipeline.

The reference normalizes on host — `iterator.setPreProcessor(new
ImagePreProcessingScaler())` converts every uint8 pixel batch to float
BEFORE it leaves the CPU (ND4J ImagePreProcessingScaler.preProcess).
That quadruples the bytes crossing the host->device link.

Here the same user code engages the device-norm seam automatically
(`data/normalization.py::engaged_device_affine`): fit() detaches the
affine-representable scaler, ships the RAW uint8 pixels (1/4 the f32
bytes), and applies `x * scale + shift` on the device.
`DL4J_CUDA_DEVICE_NORM=0` restores host normalization; evaluation
always uses the host path.
Run: python -m deeplearning4j_tpu_torch.examples.17_device_norm_image_pipeline
[--device cpu]
"""
import numpy as np

from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.data.normalization import (
    ImagePreProcessingScaler,
)
from deeplearning4j_tpu_torch.examples._common import cli, device_of
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import (
    ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer,
)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam


def make_data(n_per_class=96, seed=3):
    """Synthetic 12x12 uint8 'digits': bright blob top-left vs
    bottom-right — separable only after sane pixel scaling."""
    rs = np.random.RandomState(seed)
    imgs, labels = [], []
    for cls in range(2):
        for _ in range(n_per_class):
            img = rs.randint(0, 40, (12, 12, 1))
            r0, c0 = (1, 1) if cls == 0 else (7, 7)
            img[r0:r0 + 4, c0:c0 + 4] += rs.randint(150, 215, (4, 4, 1))
            imgs.append(img)
            labels.append(cls)
    X = np.stack(imgs).astype(np.uint8)
    Y = np.eye(2, dtype=np.float32)[np.array(labels)]
    order = rs.permutation(len(X))
    return X[order], Y[order]


def main(epochs=12, device=None):
    dev = device_of(device)
    X, Y = make_data()
    conf = (NeuralNetConfiguration.Builder().seed(7).updater(Adam(3e-3))
            .list()
            .layer(ConvolutionLayer(n_out=8, kernel=(3, 3),
                                    activation="relu"))
            .layer(SubsamplingLayer(kernel=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(OutputLayer(n_out=2, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.convolutional(12, 12, 1))
            .build())
    net = MultiLayerNetwork(conf, device=dev).init()

    it = ArrayDataSetIterator(X, Y, batch_size=48)
    it.set_pre_processor(ImagePreProcessingScaler())   # [0,255] -> [0,1]
    net.fit(it, epochs=epochs)       # uint8 crosses the link, scaled there

    ev = net.evaluate(it)            # eval: host normalization, as always
    print(f"device-norm pipeline accuracy: {ev.accuracy():.3f}")
    return ev.accuracy()


if __name__ == "__main__":
    cli(main)
