"""Generate the golden DL4J-format fixture zips + expected outputs.

The port's counterpart of the JAX package's `tools/make_dl4j_fixture.py`:
the same three models, seeds, entries and expected-output JSON, byte for
byte, with the coefficients written by the port's
`modelimport/dl4j.write_nd4j_array` (Nd4j binary, the reference flat
param order) and the configuration in the REFERENCE's on-disk form
(ModelSerializer.java zip entries; Jackson WRAPPER_OBJECT layer JSON).
Each expected forward output is computed by an independent NumPy oracle
— deliberately not by the importer under test, so a test reading the
fixture is a genuine cross-implementation regression check. Host work
only: no device, no ``--device``.

    python -m deeplearning4j_tpu_torch.tools.make_dl4j_fixture [--out DIR]

(default DIR: the repository's ``tests/fixtures/dl4j``).
"""
import argparse
import io
import json
import os
import zipfile

import numpy as np

from deeplearning4j_tpu_torch.modelimport.dl4j import write_nd4j_array

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXDIR = os.path.join(REPO, "tests", "fixtures", "dl4j")

ACT = "org.nd4j.linalg.activations.impl.Activation"
MCXENT = {"@class": "org.nd4j.linalg.lossfunctions.impl.LossMCXENT"}
ADAM = {"@class": "org.nd4j.linalg.learning.config.Adam",
        "learningRate": 1e-3, "beta1": 0.9, "beta2": 0.999,
        "epsilon": 1e-8}
FIXED_STAMP = (2026, 1, 1, 0, 0, 0)   # byte-deterministic regeneration


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _entry(name):
    # writestr(ZipInfo, ...) takes the compression from the ZipInfo, NOT
    # the archive default — set it explicitly or entries come out STORED
    zi = zipfile.ZipInfo(name, date_time=FIXED_STAMP)
    zi.compress_type = zipfile.ZIP_DEFLATED
    return zi


def _zip_model(out, name, confs, flat, indent=2):
    conf = {"backprop": True, "backpropType": "Standard", "pretrain": False,
            "confs": confs}
    zpath = os.path.join(out, name)
    with zipfile.ZipFile(zpath, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_entry("configuration.json"),
                    json.dumps(conf, indent=indent))
        buf = io.BytesIO()
        write_nd4j_array(buf, np.asarray(flat, np.float32))
        zf.writestr(_entry("coefficients.bin"), buf.getvalue())
    print("wrote", zpath)
    return zpath


def _conf(kind, body):
    body = dict(body)
    body["iUpdater"] = ADAM
    return {"layer": {kind: body}, "seed": 12345}


def _dump(out, name, doc):
    with open(os.path.join(out, name), "w") as f:
        json.dump(doc, f)


def make_mlp(out):
    """dense(16->12) relu -> softmax(5)."""
    rs = np.random.RandomState(20260730)
    nin, nh, nout = 16, 12, 5
    W1 = (rs.randn(nin, nh) * 0.3).astype(np.float32)
    b1 = (rs.randn(nh) * 0.1).astype(np.float32)
    W2 = (rs.randn(nh, nout) * 0.3).astype(np.float32)
    b2 = (rs.randn(nout) * 0.1).astype(np.float32)
    flat = np.concatenate([W1.ravel(order="F"), b1,
                           W2.ravel(order="F"), b2])
    confs = [
        {"layer": {"dense": {
            "activationFn": {"@class": ACT + "ReLU"},
            "nin": nin, "nout": nh, "hasBias": True,
            "layerName": "dense0", "iUpdater": ADAM}}, "seed": 12345},
        {"layer": {"output": {
            "activationFn": {"@class": ACT + "Softmax"},
            "nin": nh, "nout": nout, "hasBias": True,
            "lossFn": MCXENT, "iUpdater": ADAM}}, "seed": 12345},
    ]
    _zip_model(out, "mlp_mnistlike.zip", confs, flat)

    # independent oracle forward
    x = rs.randn(3, nin).astype(np.float32)
    h = np.maximum(x @ W1 + b1, 0.0)
    y = _softmax(h @ W2 + b2)
    _dump(out, "mlp_mnistlike_expected.json",
          {"input": x.tolist(), "output": y.tolist()})


def make_cnn(out):
    """conv(1->4,3x3) relu -> maxpool 2x2 -> softmax(10) on 10x10x1,
    reference NCHW layout; oracle = NumPy loops, NOT the importer."""
    rs = np.random.RandomState(20260731)
    Wc = (rs.randn(4, 1, 3, 3) * 0.4).astype(np.float32)   # (O,I,kh,kw)
    bc = (rs.randn(4) * 0.1).astype(np.float32)
    # 10x10 conv-valid -> 8x8, pool -> 4x4; flatten NCHW = 4*4*4 = 64
    Wd = (rs.randn(64, 10) * 0.2).astype(np.float32)
    bd = (rs.randn(10) * 0.1).astype(np.float32)
    flat = np.concatenate([bc, Wc.ravel(order="C"),
                           Wd.ravel(order="F"), bd])
    confs = [
        _conf("convolution", {"activationFn": {"@class": ACT + "ReLU"},
                              "nin": 1, "nout": 4, "kernelSize": [3, 3],
                              "stride": [1, 1], "padding": [0, 0],
                              "convolutionMode": "Truncate",
                              "hasBias": True}),
        _conf("subsampling", {"kernelSize": [2, 2], "stride": [2, 2],
                              "padding": [0, 0], "poolingType": "MAX",
                              "convolutionMode": "Truncate"}),
        _conf("output", {"activationFn": {"@class": ACT + "Softmax"},
                         "nin": 64, "nout": 10, "hasBias": True,
                         "lossFn": MCXENT}),
    ]
    _zip_model(out, "cnn_mnistlike.zip", confs, flat)

    x = rs.randn(2, 1, 10, 10).astype(np.float32)          # NCHW
    B = x.shape[0]
    h = np.zeros((B, 4, 8, 8), np.float32)
    for i in range(8):
        for j in range(8):
            patch = x[:, :, i:i + 3, j:j + 3]
            h[:, :, i, j] = np.einsum("bchw,ochw->bo", patch, Wc)
    h = np.maximum(h + bc[None, :, None, None], 0)
    p = np.zeros((B, 4, 4, 4), np.float32)
    for i in range(4):
        for j in range(4):
            p[:, :, i, j] = h[:, :, 2 * i:2 * i + 2,
                              2 * j:2 * j + 2].max((2, 3))
    y = _softmax(p.reshape(B, -1) @ Wd + bd)
    _dump(out, "cnn_mnistlike_expected.json",
          {"input_nchw": x.tolist(), "output": y.tolist()})


def make_lstm(out):
    """LSTM(3->5) -> rnnoutput softmax(2); reference IFOG gate order."""
    rs = np.random.RandomState(20260732)
    nin, H = 3, 5
    W = (rs.randn(nin, 4 * H) * 0.4).astype(np.float32)
    R = (rs.randn(H, 4 * H) * 0.4).astype(np.float32)
    b = (rs.randn(4 * H) * 0.1).astype(np.float32)
    Wo = (rs.randn(H, 2) * 0.4).astype(np.float32)
    bo = (rs.randn(2) * 0.1).astype(np.float32)
    flat = np.concatenate([W.ravel(order="F"), R.ravel(order="F"), b,
                           Wo.ravel(order="F"), bo])
    confs = [
        _conf("LSTM", {"activationFn": {"@class": ACT + "TanH"},
                       "nin": nin, "nout": H,
                       "gateActivationFn": {"@class": ACT + "Sigmoid"},
                       "forgetGateBiasInit": 1.0}),
        _conf("rnnoutput", {"activationFn": {"@class": ACT + "Softmax"},
                            "nin": H, "nout": 2, "lossFn": MCXENT}),
    ]
    _zip_model(out, "lstm_chars.zip", confs, flat)

    x = rs.randn(2, 6, nin).astype(np.float32)     # (B, T, F)

    def sig(z):
        return 1.0 / (1.0 + np.exp(-z))

    B, T, _ = x.shape
    h = np.zeros((B, H), np.float32)
    c = np.zeros((B, H), np.float32)
    hs = np.zeros((B, T, H), np.float32)
    for t in range(T):
        z = x[:, t] @ W + h @ R + b
        i = sig(z[:, :H])
        f = sig(z[:, H:2 * H])
        o = sig(z[:, 2 * H:3 * H])            # reference IFOG block order
        g = np.tanh(z[:, 3 * H:])
        c = f * c + i * g
        h = o * np.tanh(c)
        hs[:, t] = h
    y = _softmax(hs @ Wo + bo)
    _dump(out, "lstm_chars_expected.json",
          {"input": x.tolist(), "output": y.tolist()})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=FIXDIR,
                   help="fixture directory (default: tests/fixtures/dl4j)")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    make_mlp(args.out)
    make_cnn(args.out)
    make_lstm(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
