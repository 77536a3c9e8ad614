"""The trace's arithmetic: busy time as a union, time by kernel name, and
the breakdown's idle gaps by what the host was doing."""

import torch

from portbench.harness.trace import OUTSIDE, Trace, profiled


def trace():
    dev = [("topk_pass1<64>", 0.0, 1.0), ("topk_merge", 0.5, 1.0),
           ("memcpy", 3.0, 1.0), ("k" * 300, 6.0, 0.5)]
    host = [("aten::to", 1.0, 2.5), ("cudaMemcpyAsync", 2.9, 0.05),
            ("aten::add", 4.2, 0.1)]
    return Trace("serve", 7.0, dev, host)


def test_busy_is_a_union():
    t = trace()
    assert t.busy_s() == 1.5 + 1.0 + 0.5
    assert t.device_s("topk_pass1", "topk_merge") == 2.0
    assert t.device_s() == 3.5
    assert Trace("train", 1.0, [], []).busy_s() == 0.0


def test_breakdown():
    b = trace().breakdown()
    ops = dict(b["device_ops"])
    assert ops["topk_pass1<64>"] == 1.0 and ops["k" * 160] == 0.5
    assert [len(n) for n, _ in b["device_ops"]] == [14, 10, 6, 160]
    gaps = dict(b["idle_gaps"])
    # 1.5 .. 3.0: aten::to is still running at 3.0; 4.0 .. 6.0: nothing is
    assert gaps == {"aten::to": 1.5, OUTSIDE: 2.0}


def test_profiled_on_the_cpu_finds_no_device_records():
    t = profiled("train", lambda: torch.ones(4) + 1, "cpu")
    assert t.device == [] and t.wall_s > 0 and t.kind == "train"
