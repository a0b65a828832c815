"""The port stands alone: it imports nothing of JAX and nothing of the JAX
package, and it never quietly leaves the card for the CPU."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "ssm_rescale_check.py", ROOT / "agreement_check.py"]
BANNED = ("jax", "repro")


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"runtime.py", "lstm_seq.py", "lstm.py", "chip_smoke.py"} <= names
    # the int8-weight serving slice
    assert {"int8_matmul.py", "flash_attention.py", "quant.py", "base.py", "granite_3_8b.py",
            "granite_34b.py", "starcoder2_15b.py", "qwen15_110b.py", "layers.py",
            "transformer.py", "model.py", "kv_cache.py", "slots.py", "engine.py",
            "graphs.py"} <= names
    # the block-size tuner and the Generator stack
    assert {"autotune.py", "energy.py", "cost_model.py", "candidates.py", "constraints.py",
            "workload.py", "fpga.py", "generator.py"} <= names
    # the moe family: granite-moe and deepseek-v3 with MLA
    assert {"moe.py", "granite_moe_3b_a800m.py", "deepseek_v3_671b.py"} <= names
    # the ssm and hybrid families: mamba2 and zamba2
    assert {"ssm.py", "mamba2_780m.py", "zamba2_7b.py"} <= names
    # the audio family and the vision-language model: whisper and internvl2
    assert {"whisper_tiny.py", "internvl2_76b.py"} <= names
    # the host-side serving modules under the duty-cycle layer and the scheduler
    assert {"retry.py", "load.py", "draft.py", "faults.py", "policy.py", "power.py",
            "brownout.py"} <= names
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    roots = _imported_roots(path)
    assert not roots & set(BANNED), f"{path} imports {sorted(roots & set(BANNED))}"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_kernels_in_the_port(path):
    """The port's kernels are its own: no cuDNN LSTM, no library int8
    product or attention, no compiler-made kernels.  ``chip_smoke.py`` alone
    may time ``torch.nn.LSTM``, ``torch._int_mm`` and
    ``scaled_dot_product_attention`` as yardsticks."""
    text = path.read_text()
    banned = ["torch.compile", "cpp_extension", "import triton"]
    if path.name != "chip_smoke.py":
        banned += ["nn.LSTM", "LSTMCell", "_int_mm", "scaled_dot_product_attention"]
    assert not [b for b in banned if b in text]


def test_no_environment_switch_in_the_kernels():
    """Nothing in the kernel package reads an environment variable to pick
    the plain version; only the search for nvcc looks at CUDA_HOME/CUDA_PATH,
    and the tuner at REPRO_AUTOTUNE_CACHE, where its disk cache lives."""
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        if path.name == "runtime.py":
            assert text.count("os.environ") == 1 and "CUDA_HOME" in text
        elif path.name == "autotune.py":
            assert text.count("os.environ") == 1 and "REPRO_AUTOTUNE_CACHE" in text
            assert "getenv" not in text
        else:
            assert "os.environ" not in text and "getenv" not in text, path


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the test is about machines without one")


def test_device_none_means_the_card():
    from repro_torch.kernels.runtime import backend_key, resolve_device

    _needs_no_card()
    for device in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(device)
    assert resolve_device("cpu") == torch.device("cpu")
    assert backend_key("cpu") == "cpu"
    with pytest.raises(RuntimeError):
        backend_key()


@pytest.mark.parametrize("entry", ["plan_paper_lstm", "init_params", "params_from_numpy",
                                   "compare_lstm_paths", "compare_lstm_quant",
                                   "compare_lstm_stack", "InferenceEngine", "init_model",
                                   "SlotPool"])
def test_entry_points_raise_without_a_card(entry):
    """Asked for the card (explicitly or by default) on a machine without
    one, an entry point raises; it does not fall back to the CPU."""
    import numpy as np

    from repro_torch.kernels import bench
    from repro_torch.launch.train import plan_paper_lstm
    from repro_torch.models.lstm import lstm_defs
    from repro_torch.configs import get_reduced_config
    from repro_torch.models.model import init_model
    from repro_torch.models.params import init_params, params_from_numpy
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.slots import SlotPool

    _needs_no_card()
    cfg = get_reduced_config("granite-3-8b")
    calls = {
        "plan_paper_lstm": lambda dev: plan_paper_lstm(4, 6, device=dev),
        "init_params": lambda dev: init_params(lstm_defs(6, 20), torch.Generator(), device=dev),
        "params_from_numpy": lambda dev: params_from_numpy({"w": np.zeros(3)}, device=dev),
        "compare_lstm_paths": lambda dev: bench.compare_lstm_paths(4, 6, 6, 20, n=1, device=dev),
        "compare_lstm_quant": lambda dev: bench.compare_lstm_quant(4, 6, 6, 20, n=1, device=dev),
        "compare_lstm_stack": lambda dev: bench.compare_lstm_stack(4, 6, 6, 20, 2, n=1, device=dev),
        "InferenceEngine": lambda dev: InferenceEngine(cfg, device=dev),
        "init_model": lambda dev: init_model(cfg, torch.Generator(), dev),
        "SlotPool": lambda dev: SlotPool(cfg, max_batch=2, max_len=8, device=dev),
    }
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            calls[entry](dev)


def test_streaming_policy_raises_without_a_card():
    """The adaptive policy refits τ on a device: asked for the card (by
    default, by name, or through ``make_policy``) on a machine without one,
    it raises at construction."""
    from repro_torch.core.fpga import optimized_template, paper_workload
    from repro_torch.core.workload import AccelProfile
    from repro_torch.serving.policy import StreamingTauPolicy, make_policy

    _needs_no_card()
    prof = AccelProfile.from_template(optimized_template(), paper_workload())
    for make in (lambda: StreamingTauPolicy(prof), lambda: StreamingTauPolicy(prof, device="cuda"),
                 lambda: make_policy("adaptive", prof)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_bench_refuses_the_cpu():
    from repro_torch.kernels import bench

    with pytest.raises(ValueError, match="CUDA"):
        bench.compare_lstm_paths(4, 6, 6, 20, n=1, device="cpu")


def test_building_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler, no kernels: loading raises instead of substituting the
    plain versions."""
    from repro_torch.kernels import runtime

    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(runtime, "_find_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        runtime.load_kernels()


def test_launch_counters():
    from repro_torch.kernels import runtime
    from repro_torch.kernels.lstm_seq import lstm_seq_fused

    runtime.reset_launch_counts()
    runtime.count_launch("k")
    runtime.count_launch("k")
    assert runtime.launch_counts() == {"k": 2}
    runtime.reset_launch_counts()
    # the plain version, taken for CPU tensors, is no launch
    lstm_seq_fused(torch.zeros(2, 3, 6), torch.zeros(6, 80), torch.zeros(20, 80), torch.zeros(80))
    assert runtime.launch_counts() == {}


def test_check_launch_raises():
    from repro_torch.kernels import runtime

    runtime.check_launch(0, "k")
    for rc in (-1, -2, 9):
        with pytest.raises(RuntimeError, match="k"):
            runtime.check_launch(rc, "k")


def test_mixed_devices_are_refused():
    from repro_torch.kernels import runtime

    with pytest.raises(ValueError):
        runtime.require_same_device(torch.zeros(1), torch.zeros(1, device="meta"))
