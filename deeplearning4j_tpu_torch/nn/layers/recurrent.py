"""Recurrent layer family.

Counterpart of the JAX package's `nn/layers/recurrent.py`, every class
with the reference's fields and math: LSTM and GravesLSTM (peepholes),
SimpleRnn, GRU (both Keras layouts), Bidirectional and
GravesBidirectionalLSTM, RnnOutputLayer, RnnLossLayer, LastTimeStep and
MaskZeroLayer.

Activations are (batch, time, features). The recurrent layers hoist the
input projection of all time steps out of the loop as one ``x @ W + b``
and then run a plain Python loop over T, one ``addmm`` of the recurrent
weights and the gate math a step (the reference scans the same step with
`lax.scan`; no hand-written kernel is involved on either side). Each has
`apply`, `apply_seq(params, x, carry, ...)` returning ``(y,
final_carry)`` (the primitive behind truncated BPTT and `rnn_time_step`),
and `rnn_step` for one step. An LSTM's carry is ``(h, c)``, a SimpleRnn's
or GRU's is ``h``; ``None`` is the zero state.

Gate order [i, f, g, o]; `forget_gate_bias_init` fills the second block of
the bias. GravesLSTM's peepholes `pi`, `pf` act on the previous cell and
`po` on the new one. A (B, T) 0/1 mask follows DL4J: masked steps output
zeros and zero the carried state (`torch.where`, no host sync), so the
final carry after a masked tail is zero.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, Kind, LayerConf, register_layer,
)
from deeplearning4j_tpu_torch.nn.initializers import get_initializer
from deeplearning4j_tpu_torch.nn.losses import get_loss
from deeplearning4j_tpu_torch.parallel import tensor as tp


def _steps(xw, mask):
    """(T, B, n) views of the projections and (T, B, 1) keep flags (None
    without a mask)."""
    xs = xw.transpose(0, 1)
    keep = None if mask is None else (mask > 0).transpose(0, 1)[..., None]
    return xs, keep


def _lstm_scan(xwb, h0, c0, R, gate_act, cell_act, peep=None, mask=None):
    """An LSTM over time. `xwb`: (B, T, 4H) input projections with the
    bias added; R: (H, 4H); peep: None or (pi, pf, po), each (H,); mask:
    None or (B, T). Returns (hs (B, T, H), (hT, cT))."""
    ga = get_activation(gate_act)
    ca = get_activation(cell_act)
    xs, keep = _steps(xwb, mask)
    h, c = h0, c0
    hs = []
    for t in range(xs.shape[0]):
        zi, zf, zg, zo = torch.addmm(xs[t], h, R).chunk(4, dim=-1)
        if peep is not None:
            zi = zi + c * peep[0]
            zf = zf + c * peep[1]
        i, f, g = ga(zi), ga(zf), ca(zg)
        c = torch.addcmul(f * c, i, g)
        if peep is not None:
            zo = zo + c * peep[2]
        h = ga(zo) * ca(c)
        if keep is not None:
            h = torch.where(keep[t], h, 0.0)
            c = torch.where(keep[t], c, 0.0)
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c)


def _zeros(x, n):
    return torch.zeros((x.shape[0], n), dtype=x.dtype, device=x.device)


@register_layer
@dataclasses.dataclass(frozen=True)
class LSTM(LayerConf):
    """Standard LSTM (no peepholes), DL4J nn/conf/layers/LSTM.java."""
    n_out: int = 0
    n_in: Optional[int] = None
    activation: str = "tanh"            # cell/candidate activation
    gate_activation: str = "sigmoid"    # DL4J gateActivationFunction
    weight_init: str = "xavier"
    forget_gate_bias_init: float = 1.0  # DL4J forgetGateBiasInit

    peephole: bool = False

    def output_type(self, input_type: InputType) -> InputType:
        return InputType(Kind.RNN, (input_type.shape[0], self.n_out))

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        n_in = self.n_in or input_type.features
        H = self.n_out
        w_init = get_initializer(self.weight_init)
        b = torch.zeros((4 * H,), dtype=dtype)
        b[H:2 * H] = self.forget_gate_bias_init
        params = {"W": w_init(generator, (n_in, 4 * H), n_in, 4 * H, dtype),
                  "R": w_init(generator, (H, 4 * H), H, 4 * H, dtype),
                  "b": b}
        if self.peephole:
            for k in ("pi", "pf", "po"):
                params[k] = torch.zeros((H,), dtype=dtype)
        return params, {}

    def _peep(self, params):
        if not self.peephole:
            return None
        return params["pi"], params["pf"], params["po"]

    def _run(self, params, xwb, carry, mask):
        if carry is None:
            carry = (_zeros(xwb, self.n_out), _zeros(xwb, self.n_out))
        return _lstm_scan(xwb, carry[0], carry[1], params["R"],
                          self.gate_activation, self.activation,
                          peep=self._peep(params), mask=mask)

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        hs, _ = self.apply_seq(params, x, None, train=train, mask=mask,
                               generator=generator)
        return hs, state

    def rnn_step(self, params, x_t, carry):
        """One step of stateful inference: x_t (B, n_in), carry (h, c) or
        None. Returns (h (B, H), (h, c))."""
        xwb = torch.addmm(params["b"], x_t, params["W"])[:, None, :]
        hs, new_carry = self._run(params, xwb, carry, None)
        return hs[:, 0, :], new_carry

    def apply_seq(self, params, x, carry, *, train=False, mask=None,
                  generator=None):
        """Sequence forward from an explicit state: (y, final_carry)."""
        x = self.maybe_dropout_input(x, train, generator)
        return self._run(params, x @ params["W"] + params["b"], carry, mask)


@register_layer
@dataclasses.dataclass(frozen=True)
class GravesLSTM(LSTM):
    """LSTM with peephole connections (Graves 2013), DL4J GravesLSTM.java."""
    peephole: bool = True


@register_layer
@dataclasses.dataclass(frozen=True)
class SimpleRnn(LayerConf):
    """Vanilla RNN: h_t = act(x_t W + b + h_{t-1} R). DL4J SimpleRnn.java."""
    n_out: int = 0
    n_in: Optional[int] = None
    activation: str = "tanh"
    weight_init: str = "xavier"

    def output_type(self, input_type: InputType) -> InputType:
        return InputType(Kind.RNN, (input_type.shape[0], self.n_out))

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        n_in = self.n_in or input_type.features
        H = self.n_out
        w_init = get_initializer(self.weight_init)
        return {"W": w_init(generator, (n_in, H), n_in, H, dtype),
                "R": w_init(generator, (H, H), H, H, dtype),
                "b": torch.zeros((H,), dtype=dtype)}, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        hs, _ = self.apply_seq(params, x, None, train=train, mask=mask,
                               generator=generator)
        return hs, state

    def rnn_step(self, params, x_t, carry):
        act = get_activation(self.activation)
        h_prev = carry if carry is not None else _zeros(x_t, self.n_out)
        h = act(x_t @ params["W"] + params["b"] + h_prev @ params["R"])
        return h, h

    def apply_seq(self, params, x, carry, *, train=False, mask=None,
                  generator=None):
        x = self.maybe_dropout_input(x, train, generator)
        act = get_activation(self.activation)
        xs, keep = _steps(x @ params["W"] + params["b"], mask)
        h = carry if carry is not None else _zeros(x, self.n_out)
        hs = []
        for t in range(xs.shape[0]):
            h = act(torch.addmm(xs[t], h, params["R"]))
            if keep is not None:
                h = torch.where(keep[t], h, 0.0)
            hs.append(h)
        return torch.stack(hs, dim=1), h


@register_layer
@dataclasses.dataclass(frozen=True)
class GRU(LayerConf):
    """Gated recurrent unit in the Keras layout (the reference has no DL4J
    source for it): gates z (update), r (reset), candidate h; with
    `reset_after` the bias is (2, 3H), input and recurrent rows, else
    (3H,)."""
    n_out: int = 0
    n_in: Optional[int] = None
    activation: str = "tanh"
    gate_activation: str = "sigmoid"
    weight_init: str = "xavier"
    reset_after: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        return InputType(Kind.RNN, (input_type.shape[0], self.n_out))

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        n_in = self.n_in or input_type.features
        H = self.n_out
        w_init = get_initializer(self.weight_init)
        b_shape = (2, 3 * H) if self.reset_after else (3 * H,)
        return {"W": w_init(generator, (n_in, 3 * H), n_in, 3 * H, dtype),
                "R": w_init(generator, (H, 3 * H), H, 3 * H, dtype),
                "b": torch.zeros(b_shape, dtype=dtype)}, {}

    def _cell(self, params, xw_t, h_prev):
        """One step from the input projection xw_t (B, 3H)."""
        H = self.n_out
        ga = get_activation(self.gate_activation)
        ca = get_activation(self.activation)
        xz, xr, xh = xw_t.chunk(3, dim=-1)
        R = params["R"]
        if self.reset_after:
            hz, hr, hh = torch.addmm(params["b"][1], h_prev, R).chunk(
                3, dim=-1)
            z = ga(xz + hz)
            r = ga(xr + hr)
            cand = ca(xh + r * hh)
        else:
            # the candidate reads (r * h) @ R_h: only the z|r columns of R
            # meet h_prev directly
            hz, hr = (h_prev @ R[:, :2 * H]).chunk(2, dim=-1)
            z = ga(xz + hz)
            r = ga(xr + hr)
            cand = ca(xh + (r * h_prev) @ R[:, 2 * H:])
        return z * h_prev + (1.0 - z) * cand

    def _input_proj(self, params, x):
        ib = params["b"][0] if self.reset_after else params["b"]
        return x @ params["W"] + ib

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        hs, _ = self.apply_seq(params, x, None, train=train, mask=mask,
                               generator=generator)
        return hs, state

    def rnn_step(self, params, x_t, carry):
        h_prev = carry if carry is not None else _zeros(x_t, self.n_out)
        h = self._cell(params, self._input_proj(params, x_t), h_prev)
        return h, h

    def apply_seq(self, params, x, carry, *, train=False, mask=None,
                  generator=None):
        x = self.maybe_dropout_input(x, train, generator)
        xs, keep = _steps(self._input_proj(params, x), mask)
        h = carry if carry is not None else _zeros(x, self.n_out)
        hs = []
        for t in range(xs.shape[0]):
            h = self._cell(params, xs[t], h)
            if keep is not None:
                h = torch.where(keep[t], h, 0.0)
            hs.append(h)
        return torch.stack(hs, dim=1), h


@register_layer
@dataclasses.dataclass(frozen=True)
class Bidirectional(LayerConf):
    """Bidirectional wrapper (DL4J nn/conf/layers/recurrent/
    Bidirectional.java): the wrapped layer runs forward and on the
    time-reversed sequence (and mask), the backward output is flipped
    back unless the inner layer collapsed time (LastTimeStep), and the
    two combine per `mode`: concat | add | mul | ave."""
    layer: Optional[LayerConf] = None
    mode: str = "concat"

    def output_type(self, input_type: InputType) -> InputType:
        inner = self.layer.output_type(input_type)
        if self.mode == "concat":
            if inner.kind == Kind.FF:
                return InputType.feed_forward(2 * inner.shape[0])
            t, f = inner.shape
            return InputType(Kind.RNN, (t, 2 * f))
        return inner

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        fwd, _ = self.layer.init(generator, input_type, dtype)
        bwd, _ = self.layer.init(generator, input_type, dtype)
        return {"fwd": fwd, "bwd": bwd}, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        yf, _ = self.layer.apply(params["fwd"], {}, x, train=train,
                                 mask=mask, generator=generator)
        mr = None if mask is None else torch.flip(mask, dims=(1,))
        yb, _ = self.layer.apply(params["bwd"], {}, torch.flip(x, dims=(1,)),
                                 train=train, mask=mr, generator=generator)
        if yb.ndim == 3:    # rank 2 when the inner layer is LastTimeStep
            yb = torch.flip(yb, dims=(1,))
        if self.mode == "concat":
            y = torch.cat([yf, yb], dim=-1)
        elif self.mode == "add":
            y = yf + yb
        elif self.mode == "mul":
            y = yf * yb
        elif self.mode == "ave":
            y = 0.5 * (yf + yb)
        else:
            raise ValueError(f"Unknown Bidirectional mode {self.mode}")
        return y, state


@register_layer
@dataclasses.dataclass(frozen=True)
class GravesBidirectionalLSTM(Bidirectional):
    """DL4J GravesBidirectionalLSTM = Bidirectional(concat, GravesLSTM)."""
    n_out: int = 0
    n_in: Optional[int] = None

    def __post_init__(self):
        if self.layer is None:
            object.__setattr__(self, "layer",
                               GravesLSTM(n_out=self.n_out, n_in=self.n_in))


@register_layer
@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(LayerConf):
    """Time-distributed dense + activation (DL4J RnnOutputLayer); under
    a plan that splits ``W``'s columns over ``model``, column-parallel
    with whole logits (`parallel/tensor.linear`)."""
    TP_GROUPS = ({"W": (None, tp.MODEL)},)
    n_out: int = 0
    n_in: Optional[int] = None
    activation: str = "softmax"
    loss: str = "mcxent"
    weight_init: str = "xavier"
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.shape[0]
        return InputType(Kind.RNN, (t, self.n_out))

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        n_in = self.n_in or input_type.features
        w_init = get_initializer(self.weight_init)
        params = {"W": w_init(generator, (n_in, self.n_out), n_in,
                              self.n_out, dtype)}
        if self.has_bias:
            params["b"] = torch.zeros((self.n_out,), dtype=dtype)
        return params, {}

    def preout(self, params, x, train=False, generator=None):
        x = self.maybe_dropout_input(x, train, generator)
        return tp.linear(x, params["W"],
                         params["b"] if self.has_bias else None,
                         self.n_out, self)

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return get_activation(self.activation)(
            self.preout(params, x, train, generator)), state

    def score(self, params, x, labels, *, train=False, generator=None,
              mask=None):
        """Mean loss of the pre-activations against `labels`, over the
        unmasked steps."""
        z = self.preout(params, x, train, generator)
        return get_loss(self.loss)(labels, z, self.activation, mask=mask)


@register_layer
@dataclasses.dataclass(frozen=True)
class RnnLossLayer(LayerConf):
    """Parameter-free time-distributed loss (DL4J RnnLossLayer)."""
    activation: str = "identity"
    loss: str = "mse"

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def has_params(self):
        return False

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        return get_activation(self.activation)(x), state

    def score(self, params, x, labels, *, train=False, generator=None,
              mask=None):
        return get_loss(self.loss)(labels, x, self.activation, mask=mask)


@register_layer
@dataclasses.dataclass(frozen=True)
class LastTimeStep(LayerConf):
    """Wraps an RNN layer and emits only the last unmasked step's output
    (DL4J nn/conf/layers/recurrent/LastTimeStep.java). The step is the
    argmax of mask·(t+1), so a valid-suffix mask (Bidirectional's flip)
    works too; a fully masked row takes step 0."""
    layer: Optional[LayerConf] = None

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(
            self.layer.output_type(input_type).shape[1])

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        return self.layer.init(generator, input_type, dtype)

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        y, new_state = self.layer.apply(params, state, x, train=train,
                                        mask=mask, generator=generator)
        if mask is None:
            return y[:, -1, :], new_state
        steps = torch.arange(1, y.shape[1] + 1, device=y.device)
        idx = torch.argmax(torch.where(mask > 0, steps, 0), dim=1)
        out = y.gather(1, idx[:, None, None].expand(-1, 1, y.shape[2]))
        return out[:, 0, :], new_state


@register_layer
@dataclasses.dataclass(frozen=True)
class MaskZeroLayer(LayerConf):
    """Masks the time steps whose every input equals `mask_value` for the
    wrapped RNN, on top of any given mask (DL4J nn/layers/recurrent/
    MaskZeroLayer.java)."""
    layer: Optional[LayerConf] = None
    mask_value: float = 0.0

    def output_type(self, input_type: InputType) -> InputType:
        return self.layer.output_type(input_type)

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        return self.layer.init(generator, input_type, dtype)

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        derived = torch.where(torch.all(x == self.mask_value, dim=-1),
                              0.0, 1.0)
        if mask is not None:
            derived = derived * mask
        return self.layer.apply(params, state, x, train=train, mask=derived,
                                generator=generator)
