"""`block_multihead_attention_` under ops.yaml's signature on the card:
the op's A5 launch (bf16 pages) and A5 int8 launch (int8 pages with the
four scale tensors), one a call, held against the CPU's run of the op
(the plain version) under chip_smoke's bf16 rule (TOL_RULE), and the op
against the engine's `paged_block_attention` call on the same inputs,
bit for bit (fmha_out and the written pages). `use_pallas=False` on a
CUDA tensor raises.

Marked `gpu`: without a CUDA device every test here skips (decided in a
fixture). It imports neither jax nor the reference:

    python -m pytest tests/test_torch_bmha_op_cuda.py -m gpu --noconftest -q
"""
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch import _C_ops
from paddle_tpu_torch.ops import cuda as C
from paddle_tpu_torch.ops.kernels import serving_attention as SA
from torch_threads import one_torch_thread

one_torch_thread()

pytestmark = pytest.mark.gpu

# a smaller batch than BMHA_OP's, at its width
SMALL = dict(chip_smoke.BMHA, prefill=(40, 77), decode_past=(300, 517))


@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel A5 has no CPU mode")
    monkeypatch.setattr(chip_smoke, "BMHA", SMALL)
    return torch.device("cuda")


@pytest.mark.parametrize("int8", [False, True])
def test_op_launches_a5_once_and_equals_the_engine_form(dev, int8):
    kernel = "paged_attention_int8" if int8 else "paged_attention"
    inp = chip_smoke.bmha_inputs(torch, np, dev, int8)
    kc0, vc0 = inp["kc"].clone(), inp["vc"].clone()
    for k in C.KERNELS:
        k.reset()
    out = chip_smoke.bmha_call(_C_ops.block_multihead_attention_, inp,
                               inp["kc"], inp["vc"])
    torch.cuda.synchronize()
    n = chip_smoke.launch_counts(C)
    assert n[kernel] == 1 and sum(n.values()) == 1, n
    T = inp["T"]
    # the op packs its longest chunk of q rows a sequence
    meta = SA.paged_metadata(inp["np_cu"], np.array(inp["past"]),
                             np.array(inp["this"]), inp["np_tables"], T,
                             SMALL["bs"], inp["rope"],
                             max_q=max(inp["this"]))
    kc2, vc2 = kc0.clone(), vc0.clone()
    o2 = SA.paged_block_attention(inp["qkv"], kc2, vc2, meta,
                                  **inp["scales"])
    assert torch.equal(out[0], o2)
    assert torch.equal(out[2], kc2) and torch.equal(out[3], vc2)
    cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
           for k, v in inp.items() if k not in ("lens", "scales")}
    cpu["lens"] = {k: v.cpu() for k, v in inp["lens"].items()}
    cpu["scales"] = {k: v.cpu() for k, v in inp["scales"].items()}
    kc3, vc3 = kc0.cpu(), vc0.cpu()
    o3 = chip_smoke.bmha_call(_C_ops.block_multihead_attention_, cpu, kc3,
                              vc3)[0]
    chip_smoke.held(f"bmha {kernel}", out[0].cpu(), o3)
    if int8:
        assert int((out[2].cpu().int() - kc3.int()).abs().max()) <= 1
    else:
        chip_smoke.held("bmha key pages", out[2].cpu(), kc3)


def test_use_pallas_false_raises_on_the_card(dev):
    inp = chip_smoke.bmha_inputs(torch, np, dev, False)
    with pytest.raises(ValueError, match="ROADMAP"):
        chip_smoke.bmha_call(
            lambda *a, **k: _C_ops.block_multihead_attention_(
                *a, use_pallas=False, **k), inp, inp["kc"], inp["vc"])
