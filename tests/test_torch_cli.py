"""The port's file-based CLI (torus_fhe_tpu_torch/cli.py, ``python -m
torus_fhe_tpu_torch``) against the JAX package's (torus_fhe_tpu/cli.py).

Files cross both ways, schema ``torus_fhe_tpu.v1``: keys and ciphertexts
that the JAX CLI writes (``tfhe_test_small``) go through the port's ``eval
and``, and the JAX CLI decrypts x & y; the port's output file is word-equal
(max |diff| 0) to the JAX package's ``gate_and`` on the same files. The
port's CLI also runs alone end to end on the CPU: keygen, encrypt, eval,
decrypt (read back by the JAX CLI too), convert, tlwetn and a tiny knn,
single-key and 2-party.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torus_fhe_tpu import cli as jcli
from torus_fhe_tpu.boot import gates as jgates
from torus_fhe_tpu.utils import serialize as jser
from torus_fhe_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so that the workers of a parallel test run do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def run_port(args):
    return cli.main(["--device", "cpu"] + args)


def run_jax(args):
    return jcli.main(["--platform", "cpu"] + args)


def _last_int(capsys) -> int:
    return int(capsys.readouterr().out.strip().splitlines()[-1])


def test_jax_files_through_the_port_cli(workdir, capsys):
    assert run_jax(["keygen", "--params", "tfhe_test_small"]) == 0
    assert run_jax(["encrypt", "27", "--bits", "8", "--out", "a.npz", "--seed", "1"]) == 0
    assert run_jax(["encrypt", "202", "--bits", "8", "--out", "b.npz", "--seed", "2"]) == 0
    assert run_port(["eval", "and", "a.npz", "b.npz", "--out", "c.npz"]) == 0
    capsys.readouterr()
    assert run_jax(["decrypt", "c.npz", "--bits", "8"]) == 0
    assert _last_int(capsys) == 27 & 202
    want = jgates.gate_and(jser.load_cloud_key("cloud.key.npz"), jser.load_lwe("a.npz"),
                           jser.load_lwe("b.npz"))
    got = jser.load_lwe("c.npz")
    np.testing.assert_array_equal(np.asarray(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(np.asarray(got.b), np.asarray(want.b))


def test_port_cli_end_to_end(workdir, capsys):
    assert run_port(["keygen", "--params", "tfhe_test_small", "--forms", "conv"]) == 0
    assert run_port(["encrypt", "3000000000", "--out", "a.npz", "--seed", "1"]) == 0
    assert run_port(["encrypt", "2863311530", "--out", "b.npz", "--seed", "2"]) == 0
    for op, want in (("and", 3000000000 & 2863311530), ("xor", 3000000000 ^ 2863311530)):
        assert run_port(["eval", op, "a.npz", "b.npz", "--out", f"{op}.npz"]) == 0
        capsys.readouterr()
        assert run_port(["decrypt", f"{op}.npz"]) == 0
        assert _last_int(capsys) == want
        assert run_jax(["decrypt", f"{op}.npz"]) == 0  # the port's files, read by JAX
        assert _last_int(capsys) == want
    assert run_port(["keygen", "--forms", "scan"]) == 2


def test_port_cli_convert_and_tlwetn(workdir, capsys):
    assert run_port(["keygen", "--params", "tfhe_test_small"]) == 0
    capsys.readouterr()
    assert run_port(["convert", "13452", "223416", "--bits", "8"]) == 0
    out = capsys.readouterr().out
    assert f"expected {13452 & 223416 & 255}, direct decrypt {13452 & 223416 & 255}" in out
    assert out.count("[OK]") == 4, out
    assert run_port(["tlwetn", "3", "5", "1", "2", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "message 13452, direct decrypt 13452"
    assert all("-> 13452 [OK]" in ln for ln in lines[-4:]), lines
    assert run_port(["tlwetn", "3", "5", "1", "1", "2"]) == 2


@pytest.mark.parametrize("parties", [1, 2])
def test_port_cli_knn_tiny(workdir, capsys, parties):
    with open("cardio.csv", "w") as f:
        f.write("id,c0,c1,label\n")
        for r in [(0, 1, 2, 1), (1, 6, 7, 0), (2, 7, 7, 1)]:
            f.write(",".join(map(str, r)) + "\n")
    assert run_port(["knn", "cardio.csv", "--tiny", "--parties", str(parties), "--k", "1",
                     "--width", "4", "--shift", "0", "--train-rows", "2",
                     "--test-rows", "1"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["predictions"] == res["oracle"] == res["labels"] == [1], res
    tails = res["threshold_tail"]
    assert len(tails) == 1 and [r["bit"] for r in tails[0]] == [1] * 4, res


def test_port_cli_device_default_and_help(workdir, monkeypatch):
    """No --device is the card: without one the CLI raises and names the
    CPU's flag; --help runs as a module without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["keygen", "--params", "tfhe_test_small"])
    assert not os.path.exists("secret.key.npz")
    out = subprocess.run([sys.executable, "-m", "torus_fhe_tpu_torch", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for cmd in ("keygen", "encrypt", "eval", "decrypt", "convert", "knn", "tlwetn", "--device"):
        assert cmd in out.stdout
