"""`repro_torch.launch.roofline` against the JAX package's
`repro.launch.roofline`: with an `HW` carrying the reference's constants
(197 TFLOP/s, 819 GB/s, 50 GB/s) `roofline_terms` and `format_table`
give the reference's results on the same inputs; the H100 figures are
the datasheet's; the link rate is the caller's."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.launch import roofline as ref  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

REF_HW = roofline.HW(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)

INPUTS = [
    # flops, bytes, wire bytes, devices, model flops
    (1.366e14, 3.2e11, 4.1e10, 256, 3.108e15),
    (2.0e12, 9.9e11, 0.0, 512, 1.0e14),
    (5.5e13, 1.0e9, 7.7e12, 256, 1.4e16),
    (0.0, 0.0, 0.0, 1, 0.0),
]


@pytest.mark.parametrize("args", INPUTS)
def test_terms_equal_reference(args):
    got = roofline.roofline_terms(*args, hw=REF_HW)
    assert got == ref.roofline_terms(*args)
    assert got["n_dev"] == args[3]


def test_h100_datasheet_constants():
    assert roofline.H100_SXM.peak_flops == 989.4e12
    assert roofline.H100_SXM.hbm_bw == 3.35e12
    assert roofline.H100_SXM.link_bw is None
    with pytest.raises(ValueError, match="link rate"):
        roofline.roofline_terms(1e12, 1e9, 1e9, 256, 1e12,
                                hw=roofline.H100_SXM)
    t = roofline.roofline_terms(989.4e12, 3.35e12, 0.0, 1, 989.4e12,
                                hw=roofline.H100_SXM)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 1.0
    assert t["collective_s"] == 0.0
    hw = roofline.H100_SXM.with_link(50e9)
    assert hw.link_bw == 50e9 and hw.peak_flops == 989.4e12


def _results(fits_key, est_key):
    ok = {"arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "pod",
          "ok": True,
          "roofline": ref.roofline_terms(*INPUTS[0]),
          "roofline_flash": ref.roofline_terms(*INPUTS[2]),
          "memory": {fits_key: True, est_key: False}}
    return [ok,
            {"arch": "gemma2-9b", "shape": "long_500k", "mesh": "pod",
             "skipped": True},
            {"arch": "qwen3-4b", "shape": "decode_32k", "mesh": "multipod",
             "ok": False, "error": "RuntimeError: " + "x" * 80}]


def test_format_table_equals_reference():
    got = roofline.format_table(_results("fits_hbm", "fits_hbm_estimate"))
    want = ref.format_table(_results("fits_16GB", "fits_16GB_tpu_estimate"))
    assert got == want


def test_load_results_reads_tags(tmp_path):
    for name in ("a__train_4k__pod", "a__train_4k__pod__t1"):
        with open(os.path.join(tmp_path, name + ".json"), "w") as f:
            json.dump({"name": name}, f)
    for tag in ("", "t1"):
        got = roofline.load_results(str(tmp_path), tag)
        assert got == ref.load_results(str(tmp_path), tag)
        assert len(got) == 1
