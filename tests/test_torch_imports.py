"""The port stands alone: it imports torch, never jax and never the
reference package; its entry points do not pick the CPU on their own."""
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")


def port_modules():
    names = ["repro_torch"]
    for m in pkgutil.walk_packages([PKG], prefix="repro_torch."):
        names.append(m.name)
    return sorted(names)


def run_python(code: str, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = SRC
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_module_is_found():
    mods = port_modules()
    for want in ("repro_torch.core.api", "repro_torch.core.interpreter",
                 "repro_torch.core.memmode", "repro_torch.core.counters",
                 "repro_torch.core.speedup",
                 "repro_torch.core.policy", "repro_torch.core.formats",
                 "repro_torch.kernels._build",
                 "repro_torch.kernels.quantize_em.kernel",
                 "repro_torch.kernels.quantize_em.ops",
                 "repro_torch.kernels.quantize_em.ref",
                 "repro_torch.kernels.fused",
                 "repro_torch.kernels.flash_attention.kernel",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.flash_attention.ref",
                 "repro_torch.kernels.rwkv6.kernel",
                 "repro_torch.kernels.rwkv6.ops",
                 "repro_torch.kernels.rwkv6.ref",
                 "repro_torch.configs.h2o_danube_1_8b",
                 "repro_torch.configs.hymba_1_5b",
                 "repro_torch.configs.glm4_9b",
                 "repro_torch.configs.deepseek_coder_33b",
                 "repro_torch.configs.internlm2_20b",
                 "repro_torch.configs.olmoe_1b_7b",
                 "repro_torch.configs.deepseek_v2_236b",
                 "repro_torch.configs.rwkv6_7b",
                 "repro_torch.configs.seamless_m4t_large_v2",
                 "repro_torch.configs.qwen2_vl_7b",
                 "repro_torch.models.transformer",
                 "repro_torch.models.moe",
                 "repro_torch.models.ssm",
                 "repro_torch.models.encdec",
                 "repro_torch.models.convert",
                 "repro_torch.search", "repro_torch.search.driver",
                 "repro_torch.search.scopes", "repro_torch.search.metrics",
                 "repro_torch.apps", "repro_torch.apps.base",
                 "repro_torch.apps.sod", "repro_torch.apps.heat",
                 "repro_torch.apps.poisson", "repro_torch.apps.oracle",
                 "repro_torch.profile", "repro_torch.profile.trajectory",
                 "repro_torch.artifacts", "repro_torch.artifacts.artifact",
                 "repro_torch.artifacts.registry",
                 "repro_torch.analysis.lint",
                 "repro_torch.guardrails", "repro_torch.guardrails.log",
                 "repro_torch.guardrails.faults",
                 "repro_torch.guardrails.monitor",
                 "repro_torch.guardrails.controller",
                 "repro_torch.kernels.fp8_dot",
                 "repro_torch.serving", "repro_torch.serving.engine",
                 "repro_torch.serving.shadow", "repro_torch.launch",
                 "repro_torch.launch.serve", "repro_torch.launch.train",
                 "repro_torch.optim", "repro_torch.optim.adamw",
                 "repro_torch.optim.compression", "repro_torch.optim.tree",
                 "repro_torch.data", "repro_torch.data.pipeline",
                 "repro_torch.checkpoint",
                 "repro_torch.checkpoint.checkpointer",
                 "repro_torch.train", "repro_torch.train.trainer",
                 "repro_torch.distributed",
                 "repro_torch.distributed.fault_tolerance"):
        assert want in mods


@pytest.mark.parametrize("first", ["sorted", "reversed",
                                   "repro_torch.kernels.quantize_em.ops",
                                   "repro_torch.models.model",
                                   "repro_torch.models.moe",
                                   "repro_torch.models.encdec",
                                   "repro_torch.configs.olmoe_1b_7b",
                                   "repro_torch.kernels.flash_attention.ops",
                                   "repro_torch.kernels.rwkv6.ops",
                                   "repro_torch.search",
                                   "repro_torch.apps",
                                   "repro_torch.profile",
                                   "repro_torch.artifacts",
                                   "repro_torch.guardrails",
                                   "repro_torch.serving",
                                   "repro_torch.launch.serve",
                                   "repro_torch.launch.train",
                                   "repro_torch.train",
                                   "repro_torch.checkpoint"])
def test_importing_the_port_pulls_in_no_jax_and_no_reference_package(first):
    """In a fresh interpreter, whichever module comes first (the quantizer
    and the core import each other's submodules), import every module of
    the port, then look at ``sys.modules``."""
    mods = port_modules()
    if first == "reversed":
        mods = mods[::-1]
    elif first != "sorted":
        mods = [first] + mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'ml_dtypes')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean', len(sys.modules))\n")
    res = run_python(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "clean" in res.stdout


def python_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", python_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_jax_or_reference_package_in_source(path):
    text = open(path).read()
    bad = re.findall(
        r"^\s*(?:import\s+(?:jax|repro|ml_dtypes)\b(?!_)"
        r"|from\s+(?:jax|repro|ml_dtypes)(?:\.[\w.]+)?\s+import)",
        text, flags=re.M)
    assert not bad, (path, bad)


def test_kernel_sources_are_in_the_package():
    cu = os.path.join(PKG, "kernels", "quantize_em", "csrc", "quantize_em.cu")
    text = open(cu).read()
    assert 'extern "C" int quantize_em_static' in text
    assert 'extern "C" int quantize_em_dynamic' in text
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize_em import kernel
    flags = " ".join(_build.NVCC_FLAGS + kernel._FLAGS)
    assert "compute_90a,code=sm_90a" in flags and "fast_math" not in flags
    assert {"-ftz=false", "-prec-div=true", "-fmad=false"} <= set(kernel._FLAGS)
    assert kernel.SOURCE == os.path.relpath(cu, ROOT)


def test_entry_points_do_not_pick_the_cpu_on_their_own():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default device exists")
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.convert import params_from_jax
    from repro_torch.core import TruncationPolicy, truncate_sweep
    m = Model(get_config("h2o-danube-1.8b", "smoke"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init(seed=1, device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({}, m.cfg)
    assert m.init(device="cpu")["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        truncate_sweep(lambda: torch.ones(2) * 2.0,
                       TruncationPolicy.everywhere("e5m2"))()
    h = truncate_sweep(lambda: torch.ones(2) * 2.0,
                       TruncationPolicy.everywhere("e5m2"), device="cpu")()
    assert h.num_sites == 1
    from repro_torch.train import TrainConfig, init_opt_state
    params = m.init(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_opt_state(m, params, TrainConfig())
    assert init_opt_state(m, params, TrainConfig(),
                          device="cpu")["step"].device.type == "cpu"
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "h2o-danube-1.8b", "--steps", "1"])


def test_chip_smoke_refuses_to_run_without_a_device():
    """Exit code other than 0 and no result line, both here (no CUDA
    device) and in a directory that holds the script and nothing else."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    """Without the package beside it the script has nothing to drive: it
    must not report success from anywhere else."""
    import shutil
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize("family,entry", [
    ("flash_attention", "flash_attention_fwd"), ("rwkv6", "wkv6_fwd")])
def test_fused_kernel_sources_are_in_the_package(family, entry):
    """Each fused kernel is CUDA C++ in the package, with a plain C entry
    point, and takes its epilogue from the quantizer's shared header."""
    from repro_torch import kernels
    mod = __import__(f"repro_torch.kernels.{family}.kernel",
                     fromlist=["kernel"])
    cu = os.path.join(ROOT, mod.SOURCE)
    text = open(cu).read()
    assert f'extern "C" int {entry}' in text
    assert '#include "quantize_em.cuh"' in text
    assert "store_epilogue" in text
    assert mod.SOURCE.startswith("src/repro_torch/kernels/")
    assert not re.search(r"\batomic[A-Z]", text)  # deterministic by design
    names = {"flash_attention": "flash_attention", "rwkv6": "wkv6"}
    wrapper = kernels.kernel_wrappers()[names[family]]
    assert hasattr(wrapper, "launches")
