"""Megatron-style tensor-parallel layers: the port of
`paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py` (Paddle's
mp_layers.py: `VocabParallelEmbedding` :49, `ColumnParallelLinear` :336,
`RowParallelLinear` :543, `ParallelCrossEntropy` :744).

One process a rank, as in Paddle: each rank allocates its 1/mp shard of
the weight (`is_distributed`) and the forward issues the model-parallel
collectives of `mp_ops` around the local product. The reference, one
controller over a mesh, allocates the whole weight laid out over the mesh
and lets XLA place the same collectives. Rank r's shard is block r of the
whole weight, on the dim the reference shards. A group of one rank
computes the dense layer with no collective.
"""
from __future__ import annotations

from typing import Optional

from .....nn import functional as F
from .....nn import initializer as I
from .....nn.layer.layers import Layer
from .....nn.param_attr import ParamAttr
from .... import collective as coll
from . import mp_ops
from .random import get_rng_state_tracker  # noqa: F401 (API parity)


def _group_of(mp_group: Optional[coll.Group]):
    """(group, world size, rank) of the layer: `mp_group`, else the
    fleet's model-parallel group, else none."""
    from ...base.topology import get_hcg

    hcg = get_hcg()
    g = mp_group or (hcg.get_model_parallel_group() if hcg else None)
    if g is None:
        return None, 1, 0
    return g, g.nranks, max(g.rank, 0)


class VocabParallelEmbedding(Layer):
    """Reference: mp_layers.py:49. The table split on the vocab: rank r
    holds rows [r V/mp, (r+1) V/mp); a lookup is the shard's masked rows
    summed over the group."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group: Optional[coll.Group] = None, name=None):
        super().__init__()
        self.group, self.world_size, self.rank = _group_of(mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        assert num_embeddings % max(self.world_size, 1) == 0, (
            "vocab size must be divisible by mp degree")
        self.per_part_size = num_embeddings // max(self.world_size, 1)
        self.vocab_start_index = self.rank * self.per_part_size
        self.weight = self.create_parameter(
            [self.per_part_size, embedding_dim],
            ParamAttr._to_attr(weight_attr), self._dtype,
            default_initializer=I.XavierNormal())
        self.weight.is_distributed = self.world_size > 1

    def forward(self, x):
        if self.world_size == 1:
            return F.embedding(x, self.weight, None, False)
        emb = mp_ops._c_lookup_table(self.weight, x,
                                     start_index=self.vocab_start_index,
                                     vocab_size=self.num_embeddings)
        return mp_ops._mp_allreduce(emb, group=self.group)


class ColumnParallelLinear(Layer):
    """Reference: mp_layers.py:336. Weight [in, out] split on out: rank r
    holds columns [r out/mp, (r+1) out/mp) and its bias block."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.group, self.world_size, self.rank = _group_of(mp_group)
        self.gather_output = gather_output
        self.in_features = in_features
        self.out_features = out_features
        assert out_features % max(self.world_size, 1) == 0, (
            f"out_features {out_features} not divisible by mp "
            f"{self.world_size}")
        self.output_size_per_partition = out_features // max(
            self.world_size, 1)
        self.weight = self.create_parameter(
            [in_features, self.output_size_per_partition],
            ParamAttr._to_attr(weight_attr), self._dtype)
        self.weight.is_distributed = self.world_size > 1
        has_bias = True if has_bias is None else has_bias
        if has_bias:
            self.bias = self.create_parameter(
                [self.output_size_per_partition], ParamAttr._to_attr(None),
                self._dtype, is_bias=True)
            self.bias.is_distributed = self.world_size > 1
        else:
            self.bias = None

    def forward(self, x):
        x = mp_ops._c_identity(x, group=self.group)
        out = F.linear(x, self.weight, self.bias)
        if self.gather_output:
            out = mp_ops._c_concat(out, group=self.group)
        return out


class RowParallelLinear(Layer):
    """Reference: mp_layers.py:543. Weight [in, out] split on in: rank r
    holds rows [r in/mp, (r+1) in/mp); the bias is whole, added after the
    sum over the group."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.group, self.world_size, self.rank = _group_of(mp_group)
        self.input_is_parallel = input_is_parallel
        self.in_features = in_features
        self.out_features = out_features
        assert in_features % max(self.world_size, 1) == 0, (
            f"in_features {in_features} not divisible by mp "
            f"{self.world_size}")
        self.input_size_per_partition = in_features // max(
            self.world_size, 1)
        self.weight = self.create_parameter(
            [self.input_size_per_partition, out_features],
            ParamAttr._to_attr(weight_attr), self._dtype)
        self.weight.is_distributed = self.world_size > 1
        if has_bias:
            self.bias = self.create_parameter(
                [out_features], ParamAttr._to_attr(None), self._dtype,
                is_bias=True)
        else:
            self.bias = None

    def forward(self, x):
        if not self.input_is_parallel:
            x = mp_ops._c_split(x, group=self.group)
        out = F.linear(x, self.weight, None)
        out = mp_ops._mp_allreduce(out, group=self.group)
        if self.bias is not None:
            out = out + self.bias
        return out


class ParallelCrossEntropy(Layer):
    """Reference: mp_layers.py:744. Cross entropy from this rank's vocab
    block of the logits."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group, _, _ = _group_of(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return mp_ops._c_softmax_with_cross_entropy(
            input, label, group=self.group, ignore_index=self.ignore_index)
