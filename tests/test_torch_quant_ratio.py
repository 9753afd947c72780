"""``tools/torch_quant_ratio.py`` held to ``bench.bench_quantized_ar`` on
the CPU: the same five gradient tensors give each arm's wire bytes, the
ratio and the f32 round trip (exactly 0.0) of the JAX package's probe,
and the int8 round-trip error within 1e-6 of it; ``--check`` passes and
prints the line ``scripts/torch_quant_smoke.sh`` reads."""

import re


def test_quant_ratio_matches_bench_quantized_ar():
    import bench

    from tools import torch_quant_ratio

    want = bench.bench_quantized_ar()
    got = torch_quant_ratio.measure("cpu")
    assert (got["f32_bytes"], got["int8_bytes"]) == (
        want["fidelity_bytes"], want["int8_bytes"])
    assert round(got["quantized_ar_x"], 3) == want["value"]
    assert got["f32_roundtrip_err"] == want["fidelity_roundtrip_err"] == 0.0
    assert abs(got["int8_roundtrip_err"] - want["int8_roundtrip_err"]) \
        <= 1e-6
    out = torch_quant_ratio.main(["--device", "cpu", "--check"])
    assert out["rc"] == 0
    m = re.search(r"^quantized_ar_x = ([0-9.]+) \(gate: >= 1.5\)$",
                  out["text"], re.M)
    assert m and float(m.group(1)) == round(got["quantized_ar_x"], 3)
