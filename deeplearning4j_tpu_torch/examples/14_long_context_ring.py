"""Long-context training with sequence (ring) parallelism: the sequence
axis is split over the mesh's "seq" ranks and attention runs as a ring —
each rank holds T/S timesteps, K/V shards rotate between the ranks. The
per-shard attention is the hand-written flash kernels
(`parallel/ring.ring_flash_self_attention`: forward, dQ and dK/dV).
No DL4J analog: the reference's only long-sequence tool is truncated
BPTT.

Launched alone it trains in a one-rank group (a ring of one shard); under
a launcher with R ranks the seq degree is the largest divisor of R that
divides ``seq_mult``. The heads are 32 wide (the JAX example's are 8):
the flash kernels take head dims 32, 64 and 128.
Run: python -m deeplearning4j_tpu_torch.examples.14_long_context_ring
[--device cpu]
"""
import math

import numpy as np

from deeplearning4j_tpu_torch.examples._common import (
    cli, device_of, process_group,
)
from deeplearning4j_tpu_torch.models import TransformerLM
from deeplearning4j_tpu_torch.parallel import (
    ContextParallelTrainer, MeshConfig, build_mesh,
)
from deeplearning4j_tpu_torch.parallel.distributed import process_count


def main(epochs=6, seq_mult=4, device=None):
    dev = device_of(device)
    T = 16 * seq_mult                       # 16 timesteps per seq shard
    rs = np.random.RandomState(0)
    # next-token task over a cyclic vocabulary pattern
    starts = rs.randint(0, 40, 16)
    seqs = (starts[:, None] + np.arange(T + 1)[None]) % 40
    X = seqs[:, :-1].astype("float32")
    Y = np.eye(40, dtype="float32")[seqs[:, 1:]]

    with process_group(dev):
        seq = math.gcd(seq_mult, process_count())
        mesh = build_mesh(MeshConfig(data=-1, seq=seq))
        lm = TransformerLM(vocab_size=40, seq_length=T, n_layers=2,
                           n_embd=32, n_heads=1,
                           attention_impl="flash").init(device=dev)
        trainer = ContextParallelTrainer(lm, mesh)
        s0 = None
        for _ in range(epochs):
            trainer.fit((X, Y), epochs=1, batch_size=16)
            s0 = s0 or lm.score()
    print(f"mesh {dict(mesh.shape)} seq len {T}: "
          f"score {s0:.3f} -> {lm.score():.3f}")
    assert lm.score() < s0
    return lm.score()


if __name__ == "__main__":
    cli(main)
