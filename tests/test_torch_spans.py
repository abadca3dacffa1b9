"""The program's layer spans (utils/profiling.span): no profiler range is
made without a session; under a session a gate's span holds its rotate's
and its keyswitch's on one host lane, one keyswitch span a gate."""

import json

import pytest
import torch

from torus_fhe_tpu_torch import mk
from torus_fhe_tpu_torch.boot import api, gates
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.mk import gates3gen
from torus_fhe_tpu_torch.utils import profiling

SPANS = ("fhe.gate", "fhe.rotate", "fhe.keyswitch")


@pytest.fixture(scope="module")
def single():
    params = tparams.test_parameters(n=8, N=64)
    gen = torch.Generator().manual_seed(3)
    sk, ck = api.make_key_pair(gen, params, device="cpu")
    return sk, ck, gen


@pytest.fixture(scope="module")
def two_party():
    params = tparams.test_parameters_3gen(parties=2, n=16, N=64)
    gen = torch.Generator().manual_seed(5)
    sks = [mk.mk_party_keygen(gen, params, device="cpu") for _ in range(2)]
    ck = mk.mk_cloud_keygen(gen, sks, params, device="cpu", forms=("fblock",))
    return [sk.lwe for sk in sks], ck, gen, params


def test_span_without_a_session_makes_no_range(single, monkeypatch):
    """With no profiler session, span gives the one shared no-op context and
    no record_function is made, neither by span nor by a whole gate."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function made with no profiler session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("fhe.gate") is profiling.span("fhe.rotate")
    with profiling.span("fhe.gate"):
        pass
    sk, ck, gen = single
    x = api.encrypt(gen, sk, torch.tensor([True, False]))
    assert api.decrypt(sk, gates.gate_and(ck, x, x)).tolist() == [True, False]


def _spans(prof, tmp_path) -> list:
    """(name, start, end, lane) of the fhe.* host spans of a finished
    session's Chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                   (ev["pid"], ev["tid"])) for ev in events
                  if ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
                  and ev.get("name") in SPANS)


def _check_nested(spans: list, gate_calls: int) -> None:
    gate_spans = [s for s in spans if s[0] == "fhe.gate"]
    assert len(gate_spans) == gate_calls
    assert len({s[3] for s in spans}) == 1  # one lane: the calling thread's
    for name in ("fhe.rotate", "fhe.keyswitch"):
        inner = [s for s in spans if s[0] == name]
        assert len(inner) == gate_calls, name
        for _, start, end, _ in inner:
            assert any(g[1] <= start and end <= g[2] for g in gate_spans), name


@pytest.mark.parametrize("scheme", ["single", "two_party"])
def test_gate_spans_nest_under_a_session(scheme, single, two_party, tmp_path):
    """Under a CPU profiler session each bootstrapped gate call leaves one
    fhe.gate span on the calling thread's lane, with its fhe.rotate and
    fhe.keyswitch spans inside it."""
    from torch.profiler import ProfilerActivity, profile

    if scheme == "single":
        sk, ck, gen = single
        x = api.encrypt(gen, sk, torch.tensor([True, False, True]))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = gates.gate_and(ck, x, gates.gate_nand(ck, x, x))
        assert api.decrypt(sk, out).tolist() == [False, False, False]
    else:
        keys, ck, gen, params = two_party
        x = mk.mk_encrypt(gen, keys, torch.tensor([True, False, True]), params)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = gates3gen.mk_gate_nand(ck, x, gates3gen.mk_gate_or(ck, x, x))
        assert mk.mk_decrypt(keys, out).tolist() == [False, True, False]
    _check_nested(_spans(prof, tmp_path), gate_calls=2)


def test_one_keyswitch_span_a_gate(single, two_party, tmp_path):
    """One fhe.keyswitch span a binary gate of either scheme and one a MUX,
    whose two rotate-extracts share a keyswitch; NOT switches nothing."""
    from torch.profiler import ProfilerActivity, profile

    sk, ck, gen = single
    x = api.encrypt(gen, sk, torch.tensor([[True, False, True], [False, False, True]]))
    keys, mck, gen, params = two_party
    y = mk.mk_encrypt(gen, keys, torch.tensor([True, False, False, True]), params)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gates.gate_xor(ck, x, x)
        gates.gate_mux(ck, x, x, gates.gate_not(ck, x))
        gates3gen.mk_gate_and(mck, y, y)
        gates3gen.mk_gate_mux(mck, y, y, gates3gen.mk_gate_not(mck, y))
    names = [s[0] for s in _spans(prof, tmp_path)]
    assert names.count("fhe.gate") == names.count("fhe.keyswitch") == 4
    assert names.count("fhe.rotate") == 6
