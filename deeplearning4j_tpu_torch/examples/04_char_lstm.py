"""Char-level LSTM with truncated BPTT + streaming sampling (the
GravesLSTM character-modelling example; tutorials 08/12's RNN role).
Run: python -m deeplearning4j_tpu_torch.examples.04_char_lstm
[--device cpu]"""
import numpy as np

from deeplearning4j_tpu_torch.examples._common import cli, device_of, host
from deeplearning4j_tpu_torch.nn.conf import (
    InputType, NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam

TEXT = ("the quick brown fox jumps over the lazy dog " * 40)


def main(epochs=40, seq_len=32, units=64, device=None):
    dev = device_of(device)
    chars = sorted(set(TEXT))
    idx = {c: i for i, c in enumerate(chars)}
    V = len(chars)
    ids = np.array([idx[c] for c in TEXT])
    n = (len(ids) - 1) // seq_len
    Xi = ids[:n * seq_len].reshape(n, seq_len)
    Yi = ids[1:n * seq_len + 1].reshape(n, seq_len)
    X = np.eye(V, dtype="float32")[Xi]
    Y = np.eye(V, dtype="float32")[Yi]

    conf = (NeuralNetConfiguration.Builder().seed(7).updater(Adam(5e-3))
            .list()
            .layer(LSTM(n_out=units))
            .layer(RnnOutputLayer(n_out=V, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(V, seq_len))
            .backprop_type("tbptt", 16, 16)
            .build())
    net = MultiLayerNetwork(conf, device=dev).init()
    net.fit((X, Y), epochs=epochs, batch_size=n)

    # streaming generation via rnn_time_step (rnnTimeStep parity)
    net.rnn_clear_previous_state()
    out = "t"
    x = np.eye(V, dtype="float32")[[idx["t"]]][:, None, :]
    for _ in range(40):
        probs = host(net.rnn_time_step(x))[0, -1]
        nxt = int(probs.argmax())
        out += chars[nxt]
        x = np.eye(V, dtype="float32")[[nxt]][:, None, :]
    print("sampled:", repr(out))
    return out


if __name__ == "__main__":
    cli(main)
