"""The A/B runner of two checkouts (``microbenchmarks/ab_trees.py``) and
the timer mode it switches, on the CPU: fake checkouts whose
``chip_smoke.py`` prints lines in chip_smoke's formats."""

import json
import textwrap

from vattention_tpu_torch.microbenchmarks import ab_trees
from vattention_tpu_torch.microbenchmarks.timing import Timer

LOG = textwrap.dedent("""\
    (a) timer: device
    (a) prefill_attention: chunk 512 at kv_len 4096, Hq=32 Hkv=4 D=128 bf16: max_abs_err 0.015625 ms 0.0829 plain 2.8478 library 0.1220 bound 0.0326 (operations)
    (a) paged_prefill_attention: chunk 512 at kv_len 4096 over 16-token blocks, Hq=32 Hkv=4 D=128 bf16: ms 0.0853 plain 2.6009 library 0.1226 bound 0.0326 (operations)
    (a) segment_prefill_attention (G), 8 extents: chunk 2048 at kv_len 32768, Hq=32 Hkv=4 D=128 bf16: max abs err 0.000244140625 (row worst 0.00775) ms 2.3068 library 3.2484 (SDPA, gathered K/V) bound 1.0770 (operations)
    (a) pod_attention: chunk 512 at kv_len 4096 + B=8 depths [0, 1], Hq=32 Hkv=4 D=128 bf16: ms 0.1693, B then C serially 0.1660, plain 4.5421, SDPA prefill + SDPA decode 0.1738, bound 0.0328 (operations)
    (a) pod_attention by role: prefill role alone (every slot idle) 0.0900 ms, B 0.0830 ms; decode role alone (every run empty) 0.0950 ms, C 0.0840 ms
    (c) fa_vattn_2mb: served 8 requests in 65 steps: prompt tokens 16512 (lengths [3637]), generated tokens 256, wall 2.828 s, 90.52 generated tok/s, 5929.27 processed tok/s
    (p c) profiled 4 x (2048 + 16) tokens: wall 2884.5 ms, device busy 450.7 ms (15.6%), idle 84.4%; port kernels A-F 74.2 ms
        serial:    153.1 us/layer-call
     pod_fused:    165.9 us/layer-call
    """)


def test_parse_reads_each_line_kind():
    got = ab_trees.parse(LOG)
    assert got == {
        "(a) prefill_attention ms": 0.0829,
        "(a) prefill_attention library": 0.1220,
        "(a) paged_prefill_attention [16-token blocks] ms": 0.0853,
        "(a) paged_prefill_attention [16-token blocks] library": 0.1226,
        "(a) segment_prefill_attention [chunk 2048 at 32K] ms": 2.3068,
        "(a) segment_prefill_attention [chunk 2048 at 32K] library": 3.2484,
        "(a) pod_attention ms": 0.1693,
        "(a) pod_attention B then C": 0.1660,
        "(a) F prefill role alone ms": 0.0900,
        "(a) B beside it ms": 0.0830,
        "(a) F decode role alone ms": 0.0950,
        "(a) C beside it ms": 0.0840,
        "(c) wall s": 2.828,
        "(p c) wall ms": 2884.5,
        "(p c) device busy ms": 450.7,
        "(f) bench_pod serial us": 153.1,
        "(f) bench_pod pod_fused us": 165.9,
    }


LOG_PR6 = textwrap.dedent("""\
    (a) kv_append against index_copy_, 2 passes in turns: 0.0070 / 0.0093; 0.0071 / 0.0092 ms
    (a) host us per call (200 enqueues, no sync): kv_append 15.8, index_copy_ 9.9, SDPA (decode) 66.5
    (p c) port kernels: decode_attention_kernel 24.49 ms in 992, kv_append_kernel 1.90 ms in 992
    (f) kernel_sweep --block-size 16
    phase,kernel,ctx,latency_ms,gbps
    prefill,paged,1024,0.049,43
    decode,vattn_contig,1024,0.035,960
    decode,paged,1024,0.036,950
    """)


def test_parse_reads_the_decode_redesign_lines():
    """The lines chip_smoke prints since kernel C's redesign: A against
    index_copy_ pass by pass, host microseconds per wrapper call, each
    port kernel's device time in a profiled window, and the sweep's
    decode rows under the block size of their sweep."""
    assert ab_trees.parse(LOG_PR6) == {
        "(a) kv_append pass 0 ms": 0.0070,
        "(a) index_copy_ pass 0 ms": 0.0093,
        "(a) kv_append pass 1 ms": 0.0071,
        "(a) index_copy_ pass 1 ms": 0.0092,
        "(a) host us kv_append": 15.8,
        "(a) host us index_copy_": 9.9,
        "(a) host us SDPA (decode)": 66.5,
        "(p c) decode_attention_kernel ms": 24.49,
        "(p c) kv_append_kernel ms": 1.90,
        "(f) sweep bs 16 C vattn_contig ctx 1024 ms": 0.035,
        "(f) sweep bs 16 C paged ctx 1024 ms": 0.036,
    }


def test_parse_keys_the_quantized_lines_apart():
    """The lines of the 1-byte arenas: the (a e4m3) instances and the
    (c8) run are not read as (a) and (c); the quantized sweep's decode
    rows are keyed by its arena dtype, not by the bf16 sweep before it."""
    log = textwrap.dedent("""\
        (f) kernel_sweep --block-size 16
        decode,vattn_contig,1024,0.035,1
        (f) kernel_sweep --kv-dtype fp8 --check
        decode,vattn_contig,1024,0.026,1
        (a e4m3) prefill_attention[e4m3]: chunk 512 at kv_len 4096: max_abs_err 0.0 ms 0.1265 plain 2.3 library 0.1226 bound 0.0326 (operations)
        (c8 e4m3) fa_vattn_2mb: served 8 requests in 65 steps: wall 2.807 s
        """)
    assert ab_trees.parse(log) == {
        "(f) sweep bs 16 C vattn_contig ctx 1024 ms": 0.035,
        "(f) sweep kv fp8 C vattn_contig ctx 1024 ms": 0.026,
    }


def _fake_tree(root, name, wall):
    tree = root / name
    tree.mkdir()
    (tree / "chip_smoke.py").write_text(textwrap.dedent(f"""\
        import os
        mode = os.environ.get("VATTN_TIMER", "device")
        ms = {{"device": 0.08, "enqueue": 0.09}}[mode]
        print(f"(a) prefill_attention: chunk 512: max_abs_err 0.0 ms {{ms}} "
              "plain 1.0 library 0.12 bound 0.03 (operations)")
        print("(c) fa_vattn_2mb: served 8 requests in 65 steps: wall {wall} s")
        print('{{"ok": true, "device": {{"platform": "gpu"}}}}')
        """))
    return tree


def test_rounds_alternate_and_summarise(tmp_path, capsys):
    parent = _fake_tree(tmp_path, "parent", 2.5)
    change = _fake_tree(tmp_path, "change", 3.0)
    out = tmp_path / "ab"
    assert ab_trees.main(["--parent", str(parent), "--change", str(change),
                          "--rounds", "2", "--out", str(out)]) == 0
    summary = json.loads((out / "summary.json").read_text())
    order = [(r["label"], r["round"]) for r in summary["runs"]]
    assert order == [("parent", 0), ("change-enqueue", 0), ("change", 0),
                     ("change", 1), ("change-enqueue", 1), ("parent", 1)]
    means = summary["means"]
    assert means["(a) prefill_attention ms | parent"] == 0.08
    assert means["(a) prefill_attention ms | change-enqueue"] == 0.09
    assert means["(a) prefill_attention ms | change"] == 0.08
    assert means["(c) wall s | parent"] == 2.5
    assert means["(c) wall s | change"] == 3.0
    assert sorted(p.name for p in out.glob("*.txt")) == [
        "change-enqueue_0.txt", "change-enqueue_1.txt", "change_0.txt",
        "change_1.txt", "parent_0.txt", "parent_1.txt"]
    assert "mean parent" in capsys.readouterr().out


def test_failed_pass_fails_the_run(tmp_path):
    parent = _fake_tree(tmp_path, "parent", 2.5)
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "chip_smoke.py").write_text("raise SystemExit(1)\n")
    assert ab_trees.main(["--parent", str(parent), "--change", str(broken),
                          "--rounds", "1", "--out",
                          str(tmp_path / "ab")]) == 1


def test_timer_mode_follows_the_environment(monkeypatch):
    monkeypatch.delenv("VATTN_TIMER", raising=False)
    assert Timer("cpu").wait
    monkeypatch.setenv("VATTN_TIMER", "enqueue")
    t = Timer("cpu")
    assert not t.wait and t.mode.startswith("enqueue")
    assert t(lambda: None, iters=2, warmup=0) >= 0.0
