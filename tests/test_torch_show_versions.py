"""The port's debug report (``sq_learn_tpu_torch.show_versions``) against
the JAX package's (``sq_learn_tpu.utils._show_versions``), on the CPU:
the same System section, the port's Python dependencies (None where a
package is missing) and a "CUDA backend" section that names torch's CUDA
build, and the cards only where this process has already initialized
CUDA. In a fresh interpreter the call loads no ``jax`` module and does
not initialize CUDA.
"""

import os
import subprocess
import sys

import pytest
import torch

from sq_learn_tpu.utils import _show_versions as jax_show_versions
from sq_learn_tpu_torch import config_context
from sq_learn_tpu_torch.utils import _show_versions

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _sections(text):
    """{section title: {key: value}} of a show_versions printout."""
    out, title = {}, None
    for line in text.splitlines():
        if line.endswith(":") and not line.startswith(" "):
            title = line[:-1]
            out[title] = {}
        elif title is not None and ": " in line:
            key, value = line.split(": ", 1)
            out[title][key.strip()] = value
    return out


def test_three_sections(capsys):
    import sq_learn_tpu_torch

    sq_learn_tpu_torch.show_versions()
    sections = _sections(capsys.readouterr().out)
    assert list(sections) == ["System", "Python dependencies",
                              "CUDA backend"]
    assert set(sections["System"]) == {"python", "executable", "machine"}
    assert list(sections["Python dependencies"]) == [
        "numpy", "scipy", "torch", "triton", "einops"]
    assert sections["Python dependencies"]["torch"] == torch.__version__
    backend = sections["CUDA backend"]
    assert backend["torch CUDA"] == str(torch.version.cuda)
    assert "CUDA arch list" in backend
    if not torch.cuda.is_initialized():
        assert "devices" not in backend and "device count" not in backend


def test_system_section_equals_jax():
    assert _show_versions._get_sys_info() == \
        jax_show_versions._get_sys_info()


def test_missing_package_reads_none(monkeypatch):
    monkeypatch.setitem(sys.modules, "triton", None)  # import raises
    info = _show_versions._get_deps_info()
    assert info["triton"] is None
    assert info["numpy"] is not None and info["torch"] == torch.__version__


def test_cards_only_once_cuda_is_initialized(monkeypatch, capsys):
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    monkeypatch.setattr(torch.cuda, "get_arch_list",
                        lambda: ["sm_80", "sm_90"])
    names = []

    def name(i):
        names.append(i)
        return "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(torch.cuda, "get_device_name", name)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    info = _show_versions._get_backend_info()
    assert info == {"torch CUDA": "12.8", "CUDA arch list": "sm_80 sm_90"}
    assert names == []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    _show_versions.show_versions()
    backend = _sections(capsys.readouterr().out)["CUDA backend"]
    assert backend["torch CUDA"] == "12.8"
    assert backend["device count"] == "2"
    assert backend["devices"] == ("cuda:0 NVIDIA H100 80GB HBM3, "
                                  "cuda:1 NVIDIA H100 80GB HBM3")


_PROBE = r"""
import sys
sys.modules["sklearn"] = None
import sq_learn_tpu_torch
sq_learn_tpu_torch.show_versions()
import torch
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "sq_learn_tpu" or m.startswith("sq_learn_tpu."))
print("LOADED", loaded, "CUDA_INITIALIZED", torch.cuda.is_initialized())
"""


def test_fresh_process_loads_no_jax_and_starts_no_cuda():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED [] CUDA_INITIALIZED False" in out.stdout
    assert list(_sections(out.stdout)) == [
        "System", "Python dependencies", "CUDA backend"]
