"""Variational autoencoder layer.

Counterpart of the JAX package's `nn/layers/variational.py` (DL4J
`VariationalAutoencoder`): an unsupervised pretrain layer, encoder MLP ->
(mean, log-variance) -> reparameterized sample -> decoder MLP ->
reconstruction distribution (gaussian or bernoulli). As a stacked layer
its forward is the latent mean, as DL4J's activate().

Parameters: ``{"enc": {"0": {"W", "b"}, ...}, "muW", "mub", "dec": {...},
"outW", "outb"}``. The reference keeps each MLP as a list; the port keeps
it as a dict keyed by the list index, which has the reference's
checkpoint key paths (``enc/0/W``) and the state-dict layout flax writes
a list in, so zips and `updaterState.bin` move both ways. (Up to ten
hidden layers the port's sorted keys are also the list's order, and the
state bytes are the reference's byte for byte.)

The reference draws its noise from `jax.random.fold_in(rng, s)`, a stream
torch cannot reproduce: `pretrain_score` and `reconstruction_probability`
take either a `torch.Generator` on the input's device or the noise
itself (`eps`, one tensor of the latent mean's shape a sample), so the
same noise can be fed to both packages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, LayerConf, register_layer,
)
from deeplearning4j_tpu_torch.nn.initializers import get_initializer

_LOG_2PI = math.log(2.0 * math.pi)


@register_layer
@dataclasses.dataclass(frozen=True)
class VariationalAutoencoder(LayerConf):
    n_out: int = 0                      # latent size
    n_in: Optional[int] = None
    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    activation: str = "tanh"            # hidden activation
    pzx_activation: str = "identity"    # activation of q(z|x)'s mean
    reconstruction_distribution: str = "gaussian"   # gaussian | bernoulli
    num_samples: int = 1
    weight_init: str = "xavier"

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def _mlp_init(self, generator, sizes, dtype):
        w_init = get_initializer(self.weight_init)
        return {str(i): {"W": w_init(generator, (a, b), a, b, dtype),
                         "b": torch.zeros((b,), dtype=dtype)}
                for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        n_in = self.n_in or input_type.features
        enc_sizes = (n_in,) + tuple(self.encoder_layer_sizes)
        dec_sizes = (self.n_out,) + tuple(self.decoder_layer_sizes)
        w_init = get_initializer(self.weight_init)
        h_enc, h_dec = enc_sizes[-1], dec_sizes[-1]
        # reconstruction parameters per input: gaussian has mean + logvar
        recon = (2 if self.reconstruction_distribution == "gaussian"
                 else 1) * n_in
        enc = self._mlp_init(generator, enc_sizes, dtype)
        mu_w = w_init(generator, (h_enc, 2 * self.n_out), h_enc,
                      2 * self.n_out, dtype)
        dec = self._mlp_init(generator, dec_sizes, dtype)
        out_w = w_init(generator, (h_dec, recon), h_dec, recon, dtype)
        return {"enc": enc, "muW": mu_w,
                "mub": torch.zeros((2 * self.n_out,), dtype=dtype),
                "dec": dec, "outW": out_w,
                "outb": torch.zeros((recon,), dtype=dtype)}, {}

    def _mlp(self, layers, x):
        act = get_activation(self.activation)
        for i in range(len(layers)):
            x = act(x @ layers[str(i)]["W"] + layers[str(i)]["b"])
        return x

    def encode(self, params, x):
        """(mean, log-variance) of q(z|x)."""
        h = self._mlp(params["enc"], x)
        mu, logvar = (h @ params["muW"] + params["mub"]).chunk(2, dim=-1)
        return get_activation(self.pzx_activation)(mu), logvar

    def decode(self, params, z):
        """The reconstruction distribution's parameters (gaussian: mean
        and log-variance joined; bernoulli: logits)."""
        h = self._mlp(params["dec"], z)
        return h @ params["outW"] + params["outb"]

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        mu, _ = self.encode(params, x)
        return mu, state

    def _noise(self, mu, s, generator, eps):
        if eps is not None:
            return torch.as_tensor(eps[s]).to(device=mu.device,
                                              dtype=mu.dtype)
        if generator is None:
            raise ValueError("VariationalAutoencoder needs a `generator` "
                             "or the noise `eps`")
        return torch.randn(mu.shape, generator=generator, device=mu.device,
                           dtype=mu.dtype)

    def _log_px(self, out, x):
        """log p(x | decoder output), summed over the features."""
        if self.reconstruction_distribution == "gaussian":
            rmu, rlogvar = out.chunk(2, dim=-1)
            return -0.5 * (rlogvar + (x - rmu) ** 2 / torch.exp(rlogvar)
                           + _LOG_2PI).sum(-1)
        if self.reconstruction_distribution == "bernoulli":
            return -(out.clamp_min(0) - out * x
                     + torch.log1p(torch.exp(-out.abs()))).sum(-1)
        raise ValueError(self.reconstruction_distribution)

    def pretrain_score(self, params, x, generator=None,
                       eps: Optional[Sequence] = None):
        """The negative ELBO, averaged over the batch: the reconstruction
        NLL over `num_samples` reparameterized samples plus KL(q(z|x) ||
        N(0, I)). `eps[s]` is sample s's noise; without it the noise is
        drawn from `generator`."""
        mu, logvar = self.encode(params, x)
        kl = -0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar)).sum(-1)
        total_recon = 0.0
        for s in range(self.num_samples):
            z = mu + torch.exp(0.5 * logvar) * self._noise(mu, s, generator,
                                                           eps)
            total_recon = total_recon - self._log_px(self.decode(params, z),
                                                     x)
        return (total_recon / self.num_samples + kl).mean()

    def reconstruction_probability(self, params, x, generator=None,
                                   num_samples: int = 5,
                                   eps: Optional[Sequence] = None):
        """Monte-Carlo estimate of log p(x) per example (DL4J
        reconstructionLogProbability): logsumexp over `num_samples`
        samples of log p(x|z), less log(num_samples)."""
        mu, logvar = self.encode(params, x)
        logps = torch.stack([
            self._log_px(self.decode(params, mu + torch.exp(0.5 * logvar)
                                     * self._noise(mu, s, generator, eps)),
                         x)
            for s in range(num_samples)])
        return torch.logsumexp(logps, dim=0) - math.log(float(num_samples))
