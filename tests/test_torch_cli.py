"""The port's `ola-torch` CLI (olavm_tpu_torch/cli/main.py) against
olavm_tpu's `ola`: asm and run on the fib-loop fixture at N=10 (calldata
0, 0; chip_smoke.cli_stages) write the same bytes; `prove` takes the card by
default and raises where there is none, never proving on the CPU by itself;
`prove -b host` runs the carried numpy prover, whose proof equals
tests/fixtures/cli_fib_golden.json and verifies (slow: the 12-table host
prove takes about a minute)."""

import hashlib
import json
import os

import pytest
import torch

from chip_smoke import cli_stages
from olavm_tpu.cli import main as jcli
from olavm_tpu_torch.cli import main as tcli
import torch_threads  # noqa: F401  (torch's share of the cores)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def stages(tmp_path):
    """Both CLIs' asm and run outputs, each in its own directory."""
    out = {}
    for name, cli in (("port", tcli), ("reference", jcli)):
        d = tmp_path / name
        d.mkdir()
        argvs, paths = cli_stages(10, str(d))
        for stage in ("asm", "run"):
            cli.main(argvs[stage])
        out[name] = (argvs, paths)
    return out


@pytest.mark.parametrize("stage", ["asm", "run"])
def test_stage_writes_the_reference_bytes(stages, stage):
    port, ref = stages["port"][1][stage], stages["reference"][1][stage]
    assert _read(port) == _read(ref) and os.path.getsize(port) > 0


def test_prove_default_backend_is_the_card(stages):
    argvs, paths = stages["port"]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default backend exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(argvs["prove"])
    assert not os.path.exists(paths["prove"])


def test_backend_choices(capsys):
    with pytest.raises(SystemExit):
        tcli.main(["prove", "-i", "x", "-o", "y", "-b", "auto"])
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.slow
def test_host_prove_then_verify_matches_golden(stages, capsys):
    argvs, paths = stages["port"]
    tcli.main(argvs["prove"] + ["-b", "host"])
    tcli.main(argvs["verify"])
    assert "Verify succeed!" in capsys.readouterr().out
    with open(os.path.join(FIXTURES, "cli_fib_golden.json")) as f:
        golden = json.load(f)
    data = _read(paths["prove"])
    assert (hashlib.sha256(data).hexdigest(), len(data)) == (
        golden["proof_sha256"], golden["proof_bytes"])
