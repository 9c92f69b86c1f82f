"""Shared encoded-gradient training between nodes.

Counterpart of the JAX package's `parallel/shared.py`: DL4J's quantized
gradient sharing (`SharedTrainingMaster.java:475`,
`WiredEncodingHandler.java:20-89`, `SilentTrainingDriver.java:112-121`).
Each worker computes gradients on its block of the batch, threshold-
encodes them (`encoding.EncodingHandler`, with its own residual carry:
on the model's device, with the native host codec on the rank path of a
model on the CPU), exchanges the sparse messages over a transport, and
applies the decoded sum through the same updater.

Every replica sums the same messages in the same order (the own message
and the peers', ordered by their wire bytes), so the replicas stay
bitwise equal without a parameter broadcast. `LoopbackTransport` runs
every worker in one process (the reference's own test strategy);
`SocketTransport` (`transport.py`) carries messages between processes.
Within a node, `ParallelWrapper`'s all-reduce is the faster path.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel.encoding import EncodingHandler
from deeplearning4j_tpu_torch.util import params as param_util


class LoopbackTransport:
    """In-process message exchange between logical workers (message =
    (indices, payload, scalar), the SilentUpdatesMessage analog)."""

    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self._inbox: List[list] = [[] for _ in range(n_workers)]
        self.messages_sent = 0
        self.bytes_sent = 0

    def broadcast(self, sender: int, message: Tuple):
        idx, payload, _ = message
        self.messages_sent += self.n_workers - 1
        # int32 index + payload element (int8 sign or f32 value) + scalar
        per_el = 4 + np.asarray(payload).dtype.itemsize
        self.bytes_sent += (self.n_workers - 1) * (np.size(idx) * per_el + 4)
        for w in range(self.n_workers):
            if w != sender:
                self._inbox[w].append(message)

    def drain(self, worker: int) -> List[Tuple]:
        msgs, self._inbox[worker] = self._inbox[worker], []
        return msgs


def _wire_key(message) -> bytes:
    from deeplearning4j_tpu_torch.parallel.transport import _encode_message
    return _encode_message(message)


@dataclasses.dataclass
class SharedGradientsTrainer:
    """Data parallelism with threshold-encoded gradient exchange.

    In-process simulation of every worker (loopback transport):
        trainer = SharedGradientsTrainer(net, n_workers=2, threshold=1e-3)
        trainer.fit(iterator, epochs=2)
        trainer.compression_ratio()   # bytes on the wire vs dense f32

    One OS process per worker over sockets:
        transport = SocketTransport(rank=r, n_workers=2)
        trainer = SharedGradientsTrainer(net, n_workers=2, rank=r,
                                         transport=transport)
        trainer.fit(iterator, epochs=2)   # blocks on peers each iteration

    Worker w's dropout generator is seeded ``conf.seed + 86243 +
    1000003 x w``.
    """
    model: object
    n_workers: int = 2
    threshold: float = 1e-3
    # target sent density; the encoder's hard cap is 20% of elements
    boundary: float = 0.15
    transport: Optional[object] = None
    # None = simulate every worker in this process (LoopbackTransport);
    # an integer = THIS process is worker `rank`
    rank: Optional[int] = None

    def __post_init__(self):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        self._is_graph = isinstance(self.model, ComputationGraph)
        if self.model.params is None:
            raise ValueError("model must be init()ed first")
        if self.transport is None:
            if self.rank is not None:
                raise ValueError("rank-based training needs a transport "
                                 "(e.g. SocketTransport)")
            self.transport = LoopbackTransport(self.n_workers)
        # a rank whose gradient is on the host already encodes it with the
        # C++ codec (the reference's native thresholdEncode); a gradient on
        # the card is encoded there, and only the capped message crosses
        backend = "torch"
        if self.rank is not None and torch.device(
                self.model.device).type == "cpu":
            from deeplearning4j_tpu_torch import native
            if native.available():
                backend = "native"
        self.handlers = [EncodingHandler(threshold=self.threshold,
                                         boundary=self.boundary,
                                         max_density=0.2, backend=backend)
                         for _ in range(self.n_workers)]
        self._gens = None
        self._dense_bytes = 0
        self.iteration_count = 0

    # ---------------------------------------------------------------- math
    def _gradient(self, x, y, generator):
        """(flat gradient / n_workers, loss, new layer state) on one block."""
        net = self.model
        if self._is_graph:
            score = lambda live: net._score_fn(     # noqa: E731
                live, net.state, net._stage_inputs((x,)),
                net._as_labels((y,)), None, None, True, generator)
        else:
            score = lambda live: net._score_fn(     # noqa: E731
                live, net.state, net._stage_x(x), net._as_labels(y), None,
                None, True, generator)
        loss, grads, (new_state, _) = net._gradients(score)
        # pre-scaled by 1/n: the decoded SUM over workers is the mean
        flat = param_util.params_to_flat(grads) / self.n_workers
        return flat, loss, new_state

    def _apply(self, flat_update):
        net = self.model
        grads = param_util.flat_to_params(flat_update, net.params)
        net._update(grads)

    # ------------------------------------------------------------------ fit
    def _iter_source(self, data, batch_size):
        """(features, labels) minibatches for either container type
        (single-input/single-output graphs, no masks)."""
        if self._is_graph:
            for mds in self.model._iter_data(data):
                if len(mds.features) != 1 or len(mds.labels) != 1:
                    raise ValueError("encoded-gradient training supports "
                                     "single-input/single-output graphs")
                if mds.features_masks is not None or \
                        mds.labels_masks is not None:
                    raise ValueError("encoded-gradient training does not "
                                     "thread masks; strip them or use "
                                     "ParallelWrapper")
                x = np.asarray(mds.features[0])
                y = np.asarray(mds.labels[0])
                for lo in range(0, len(x), batch_size):
                    yield x[lo:lo + batch_size], y[lo:lo + batch_size]
            if hasattr(data, "reset"):
                data.reset()
        else:
            source = self.model._as_iterator(data, batch_size)
            for ds in source:
                yield ds.features, ds.labels
            source.reset()

    def fit(self, data, epochs: int = 1, batch_size: int = 32):
        net = self.model
        if self._gens is None:
            self._gens = [torch.Generator(device=net.device).manual_seed(
                net.conf.seed + 86243 + 1000003 * w)
                for w in range(self.n_workers)]
        for _ in range(epochs):
            for x, y in self._iter_source(data, batch_size):
                self._iteration(x, y)
            net.epoch_count += 1
        return net

    def _sum(self, messages, n_params: int) -> torch.Tensor:
        """The decoded sum of `messages`, in their wire bytes' order."""
        handler = self.handlers[0]
        device = self.model.device
        total = torch.zeros((n_params,), dtype=torch.float32, device=device)
        for idx, payload, scalar in sorted(messages, key=_wire_key):
            total = total + handler.decode(
                torch.as_tensor(np.asarray(idx)).to(device),
                torch.as_tensor(np.asarray(payload)).to(device), scalar,
                (n_params,))
        return total

    @staticmethod
    def _host(message):
        idx, payload, scalar = message
        return (idx.detach().cpu().numpy().astype(np.int32),
                payload.detach().cpu().numpy(), float(scalar))

    def _iteration(self, x, y):
        if self.rank is not None:
            return self._iteration_distributed(x, y)
        net = self.model
        shards = self._split(x, y)
        n_params = net.num_params()
        messages, losses, sizes, new_states = [], [], [], []
        for w, (xw, yw) in enumerate(shards):
            flat, loss_w, new_state = self._gradient(xw, yw, self._gens[w])
            msg = self._host(self.handlers[w].encode(flat))
            messages.append(msg)
            self.transport.broadcast(w, msg)
            losses.append(float(loss_w))
            sizes.append(int(np.shape(xw)[0]))
            new_states.append(new_state)
        # batch-norm statistics: the batch-weighted mean over workers
        wts = np.asarray(sizes, np.float64) / float(sum(sizes))
        from deeplearning4j_tpu_torch.nn.updaters import tree_map
        merged = tree_map(lambda *ls: sum(float(w) * t for w, t in
                                          zip(wts, ls)), *new_states)
        net._commit_state(merged)
        loss = float(np.dot(wts, np.asarray(losses)))
        self._dense_bytes += self.n_workers * (self.n_workers - 1) * \
            n_params * 4
        for w in range(self.n_workers):      # every inbox drains
            self.transport.drain(w)
        self._apply(self._sum(messages, n_params))
        self._finish(loss, int(np.shape(x)[0]))

    def _iteration_distributed(self, x, y):
        """One lockstep iteration of THIS worker: gradients on its block,
        its message broadcast, the peers' awaited, the same ordered sum
        applied."""
        net = self.model
        xw, yw = self._split(x, y)[self.rank]
        n_params = net.num_params()
        flat, loss, new_state = self._gradient(xw, yw, self._gens[self.rank])
        own = self._host(self.handlers[self.rank].encode(flat))
        self.transport.broadcast(self.rank, own)
        peers = self.transport.recv(self.n_workers - 1)
        self._dense_bytes += (self.n_workers - 1) * n_params * 4
        self._apply(self._sum([own] + list(peers), n_params))
        net._commit_state(new_state)   # batch-norm stats stay per worker
        self._finish(float(loss), int(np.shape(xw)[0]))

    def _finish(self, loss: float, bs: int):
        net = self.model
        net._score = loss
        for lst in net.listeners:
            lst.iteration_done(net, self.iteration_count, net.epoch_count,
                               net._score, 0.0, bs)
        self.iteration_count += 1
        net.iteration_count += 1

    def _split(self, x, y):
        """Contiguous batch blocks, one per worker (a ragged tail goes to
        the last)."""
        x = np.asarray(x)
        y = np.asarray(y)
        n = x.shape[0]
        per = max(1, n // self.n_workers)
        shards = []
        for w in range(self.n_workers):
            lo = min(w * per, n)
            hi = n if w == self.n_workers - 1 else min((w + 1) * per, n)
            if hi <= lo:            # more workers than samples
                lo, hi = 0, n
            shards.append((x[lo:hi], y[lo:hi]))
        return shards

    # ------------------------------------------------------------ reporting
    def compression_ratio(self) -> float:
        """Wire bytes vs dense float32 exchange (lower is better)."""
        if self._dense_bytes == 0:
            return 1.0
        return self.transport.bytes_sent / self._dense_bytes

    def sparsity(self) -> float:
        return float(np.mean([h.last_sparsity for h in self.handlers]))
