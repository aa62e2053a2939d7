"""`io` and `PyLayer`, the port against the reference on the CPU.

- DataLoader: the same numpy dataset in both packages, shuffle off; the
  port's batches in process (with drop_last on and off and a batch
  sampler) and from 2 worker processes (over a TensorDataset) equal the
  reference's in-process batches exactly (values, dtypes, order); the
  last partial batch kept or dropped as the reference does.
- Samplers: with numpy's generator seeded, `RandomSampler` gives the
  reference's permutation (both draw from numpy's global generator), and
  a permutation; `DistributedBatchSampler` shards as the reference's.
- PyLayer: a custom forward and backward (the backward deliberately
  not the forward's derivative) gives the reference's outputs and
  gradients within rtol 1e-6.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu_torch.core import place as port_place
from torch_threads import one_torch_thread

one_torch_thread()


@pytest.fixture(autouse=True)
def _cpu():
    port_place.set_device("cpu")
    yield
    port_place._current[0] = None


class _Samples:
    """20 samples: a float row, an int label, a dict of an array."""

    def __init__(self, n=20):
        rs = np.random.RandomState(0)
        self.x = rs.randn(n, 3).astype(np.float32)
        self.y = rs.randint(0, 10, n)

    def __getitem__(self, i):
        return self.x[i], int(self.y[i]), {"w": self.x[i] * 2.0}

    def __len__(self):
        return len(self.x)


class PortSamples(_Samples, port.io.Dataset):
    pass


class RefSamples(_Samples, ref.io.Dataset):
    pass


def _host(batch):
    x, y, d = batch
    return [(a.numpy(), a.numpy().dtype) for a in (x, y, d["w"])]


def _batches(pd, ds, **kw):
    return [_host(b) for b in pd.io.DataLoader(ds, **kw)]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for (ga, gt), (wa, wt) in zip(g, w):
            assert gt == wt
            np.testing.assert_array_equal(ga, wa)


@pytest.mark.parametrize("drop_last", [False, True])
def test_dataloader_in_process_matches_the_reference(drop_last):
    kw = dict(batch_size=6, shuffle=False, drop_last=drop_last)
    want = _batches(ref, RefSamples(), **kw)
    _equal(_batches(port, PortSamples(), **kw), want)
    assert len(want) == (3 if drop_last else 4)


def test_dataloader_two_workers_match_the_reference():
    """The port's worker processes on a TensorDataset (its workers then
    import the port alone, not this module and the reference)."""
    s = _Samples()
    want = [[(a.numpy(), a.numpy().dtype) for a in b] for b in
            ref.io.DataLoader(ref.io.TensorDataset(
                [ref.to_tensor(s.x), ref.to_tensor(s.y)]), batch_size=6)]
    got = [[(a.numpy(), a.numpy().dtype) for a in b] for b in
           port.io.DataLoader(port.io.TensorDataset(
               [port.to_tensor(s.x), port.to_tensor(s.y)]), batch_size=6,
               num_workers=2)]
    _equal(got, want)


def test_dataloader_batch_sampler_and_collate():
    def collate(samples):
        return (np.stack([s[0] for s in samples]),
                np.asarray([s[1] for s in samples], np.int64),
                {"w": np.stack([s[2]["w"] for s in samples])})

    outs = []
    for pd, ds in ((ref, RefSamples()), (port, PortSamples())):
        bs = pd.io.BatchSampler(ds, batch_size=7)
        outs.append(_batches(pd, ds, batch_sampler=bs, collate_fn=collate))
    _equal(outs[1], outs[0])


def test_random_sampler_is_the_reference_permutation():
    orders = []
    for pd, ds in ((ref, RefSamples()), (port, PortSamples())):
        np.random.seed(123)
        orders.append(list(pd.io.RandomSampler(ds)))
    assert orders[1] == orders[0]
    assert sorted(orders[1]) == list(range(20))
    assert orders[1] != list(range(20))


@pytest.mark.parametrize("shuffle", [False, True])
def test_distributed_batch_sampler_shards_as_the_reference(shuffle):
    shards = []
    for pd, ds in ((ref, RefSamples()), (port, PortSamples())):
        per_rank = []
        for rank in range(3):
            s = pd.io.DistributedBatchSampler(ds, batch_size=4,
                                              num_replicas=3, rank=rank,
                                              shuffle=shuffle)
            s.set_epoch(2)
            per_rank.append(list(s))
        shards.append(per_rank)
    assert shards[1] == shards[0]


def test_tensor_dataset_and_subset():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    ds = port.io.TensorDataset([port.to_tensor(x)])
    sub = port.io.Subset(ds, [4, 1])
    assert [s[0].numpy().tolist() for s in sub] == [[8.0, 9.0], [2.0, 3.0]]
    cat = port.io.ConcatDataset([PortSamples(3), PortSamples(2)])
    assert len(cat) == 5 and cat[4][1] == PortSamples(2)[1][1]


def _pylayer(pd):
    class Scaled(pd.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, w, alpha=2.0):
            ctx.save_for_backward(x, w)
            ctx.alpha = alpha
            return pd.tanh(x) * w, x.sum() * 0.0 + alpha

        @staticmethod
        def backward(ctx, dy, dz):
            x, w = ctx.saved_tensor()
            # not the forward's derivative: the custom rule must be used
            return dy * w * ctx.alpha, dy * x

    return Scaled


def test_pylayer_custom_backward_matches_the_reference():
    rs = np.random.RandomState(0)
    x0, w0 = rs.randn(3, 4).astype(np.float32), rs.randn(3, 4).astype(
        np.float32)
    outs = []
    for pd in (ref, port):
        x, w = pd.to_tensor(x0), pd.to_tensor(w0)
        x.stop_gradient = False
        w.stop_gradient = False
        y, z = _pylayer(pd).apply(x, w, alpha=3.0)
        (y * y).sum().backward()
        outs.append((y.numpy(), z.numpy(), x.grad.numpy(), w.grad.numpy()))
    for r, p in zip(outs[0], outs[1]):
        np.testing.assert_allclose(p, r, rtol=1e-6, atol=1e-6)


def test_pylayer_without_gradients_runs_forward_only():
    x = port.to_tensor(np.ones((2, 2), np.float32))
    y, _ = _pylayer(port).apply(x, x)
    assert y.stop_gradient
    np.testing.assert_allclose(y.numpy(), np.tanh(1.0), rtol=1e-6)
