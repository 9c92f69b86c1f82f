"""TransformerLM — the decoder-only LM family.

Counterpart of the JAX package's `models/transformer.py`: the same fields,
defaults and config, so ``zoo:TransformerLM?...`` builds the same
network in both packages, and `sharding_rules` is the reference's
tensor- and expert-parallel rule table.
"""
from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf.base import InputType
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (
    EmbeddingSequenceLayer, LayerNormLayer, MoEFeedForward, RnnOutputLayer,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.nn.updaters import AdamW


@dataclasses.dataclass
class TransformerLM(ZooModel):
    """Decoder-only LM: token embedding -> n_layers TransformerBlocks
    (optionally interleaved MoE FFN blocks) -> LN -> softmax head."""
    vocab_size: int = 1024
    seq_length: int = 256
    n_layers: int = 4
    n_embd: int = 256
    n_heads: int = 8
    mlp_ratio: int = 4
    causal: bool = True
    use_rope: bool = True
    moe_every: int = 0          # 0 = dense; k>0 = every k-th block is MoE
    n_experts: int = 8
    dropout: float = 0.0
    learning_rate: float = 3e-4
    seed: int = 123
    attention_impl: str = "dense"
    block_size: int = 512

    def conf(self):
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed)
             .updater(AdamW(self.learning_rate))
             .grad_clip_norm(1.0)
             .list())
        b.layer(EmbeddingSequenceLayer(n_out=self.n_embd,
                                       n_in=self.vocab_size))
        for i in range(self.n_layers):
            b.layer(TransformerBlock(
                n_out=self.n_embd, n_heads=self.n_heads,
                mlp_ratio=self.mlp_ratio, causal=self.causal,
                use_rope=self.use_rope,
                attention_dropout=self.dropout,
                residual_dropout=self.dropout,
                attention_impl=self.attention_impl,
                block_size=self.block_size))
            if self.moe_every and (i + 1) % self.moe_every == 0:
                b.layer(MoEFeedForward(n_out=self.n_embd,
                                       n_experts=self.n_experts,
                                       mlp_ratio=self.mlp_ratio))
        b.layer(LayerNormLayer())
        b.layer(RnnOutputLayer(n_out=self.vocab_size, activation="softmax",
                               loss="mcxent"))
        b.set_input_type(InputType.recurrent(1, self.seq_length))
        return b.build()

    @staticmethod
    def sharding_rules():
        """Megatron tp + ep rules for the stack above. Paths look like
        "1/attn/Wq" (block params are nested dicts)."""
        from deeplearning4j_tpu_torch.parallel.mesh import MODEL_AXIS, P
        from deeplearning4j_tpu_torch.parallel.sharding import ShardingRules
        return ShardingRules((
            # attention: column-parallel QKV, row-parallel output
            (r".*/attn/W[qkv]$", P(None, MODEL_AXIS)),
            (r".*/attn/Wo$", P(MODEL_AXIS, None)),
            # MoE (3D, leading expert dim): expert parallelism over
            # "model"; listed before the dense rules, since spec_for
            # skips a rule longer than the leaf's rank
            (r".*/W1$", P(MODEL_AXIS, None, None)),
            (r".*/W2$", P(MODEL_AXIS, None, None)),
            # dense MLP: column-parallel up, row-parallel down
            (r".*/W1$", P(None, MODEL_AXIS)),
            (r".*/W2$", P(MODEL_AXIS, None)),
            # embedding: vocab-sharded
            (r"^0/W$", P(MODEL_AXIS, None)),
        ))


@dataclasses.dataclass
class TransformerLMMoE(TransformerLM):
    """Expert-parallel variant: every 2nd block followed by a top-2 MoE FFN."""
    moe_every: int = 2
    n_experts: int = 8
