"""chip_smoke.py's host-side logic, on the CPU.

The attention kernels' check must catch faults that only move deep rows,
whose outputs are small: the one-query-token-per-row comparison against
each row's largest output does, where atol = rtol = 2e-2 alone does not.
"""

import importlib.util
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def chunk_case(Tq=64, K=4096, H=8, D=128):
    """One GQA group of Yi-6B attending a chunk of Tq tokens at depth K."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(Tq, H, D, generator=g).bfloat16().float()
    k = torch.randn(K, D, generator=g).bfloat16().float()
    v = torch.randn(K, D, generator=g).bfloat16().float()
    pos = torch.arange(K - Tq, K)[:, None]
    keys = torch.arange(K)[None, :]
    s = torch.einsum("thd,kd->thk", q, k) * D ** -0.5

    def attend(mask):
        p = torch.softmax(s.masked_fill(~mask[:, None, :], float("-inf")), -1)
        return torch.einsum("thk,kd->thd", p, v).bfloat16()

    return attend, pos, keys


@pytest.mark.parametrize("fault", ["diagonal key of every 8th row",
                                   "causal mask off by one"])
def test_attention_check_catches_deep_faults(fault):
    cs = load_chip_smoke()
    attend, pos, keys = chunk_case()
    causal = keys <= pos
    ref = attend(causal)
    if fault == "causal mask off by one":
        bad = attend(keys < pos)
    else:
        row = torch.arange(pos.shape[0])[:, None]
        bad = attend(causal & ~((keys == pos) & (row % 8 == 7)))
    # the absolute tolerance alone lets the fault through ...
    torch.testing.assert_close(bad.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    # ... the row-wise check does not
    with pytest.raises(AssertionError, match="largest output"):
        cs.check_attention(fault, bad, ref, 2e-2)
    err, rel = cs.check_attention("same", ref, ref, 2e-2)
    assert err == 0.0 and rel == 0.0


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
