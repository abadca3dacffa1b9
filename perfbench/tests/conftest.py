"""Small sizes for the benchmark's CPU tests, and the marker of the tests
that need the card (``cuda``: skipped where torch.cuda.is_available() is
false, decided inside the test)."""

import dataclasses
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs the benchmark on an NVIDIA GPU; skips without one")


def small_config(scheme: str) -> dict:
    """A configuration dict of the insecure test sets (n=16, N=64), under a
    registry name of the program's."""
    from torus_fhe_tpu_torch.core import params as P

    if scheme == "single":
        p, name, parties = P.test_parameters(n=16, N=64), "tfhe_test_small", 1
    else:
        p, name, parties = P.test_parameters_3gen(2, n=16, N=64), "perfbench_test_3gen", 2
        P.PARAMETER_REGISTRY.setdefault(name, lambda: P.test_parameters_3gen(2, n=16, N=64))
    return {"name": "small_" + scheme, "scheme": scheme, "registry": name, "parties": parties,
            "params": dataclasses.asdict(p)}


# the layered mixes keep every gate for the check: at one or two layers a
# window, a sample of a layer would miss a fault in one gate a call
SMALL_MIXES = {
    "tfhe128.wide": {"kind": "layered", "batch": 64, "gates": ["and", "nand", "or", "xor"],
                     "lookahead": 2, "checked_per_layer": 64},
    "mk2p3gen.wide": {"kind": "layered", "batch": 64, "gates": ["nand"], "lookahead": 2,
                      "checked_per_layer": 64},
    "tfhe128.cmp8": {"kind": "circuit", "circuit": "less_than", "width": 8, "operand_bits": 7,
                     "batch": 1, "pool": 4},
    "mk2p3gen.add8": {"kind": "circuit", "circuit": "add", "width": 8, "operand_bits": 8,
                      "batch": 1, "pool": 4},
}
SCHEME = {"tfhe128.wide": "single", "mk2p3gen.wide": "3gen", "tfhe128.cmp8": "single",
          "mk2p3gen.add8": "3gen"}


@pytest.fixture
def small():
    """(configuration, mix) of a cell at the test sizes."""
    return lambda workload: (small_config(SCHEME[workload]), SMALL_MIXES[workload])
