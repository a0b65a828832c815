"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU
(``--device cpu``), on reduced configs: every mode returns 0 and prints its
rows; ``compare --paged`` prints the paged row's cache bytes and preemption
counters; the robustness, memory and power flags reach the scheduler; bad
arguments fail as the reference's launcher fails them (argparse's exit
code 2); the port's parser has every flag of the reference's and
``--device``, whose default is the card.

The numbers the launcher prints come from costs measured on the CPU
(``EngineCalibration``), so no line is compared with the reference's; its
parity is the scheduler's (``test_torch_scheduler*``)."""
import argparse
import re

import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.launch import serve as tserve

torch.set_num_threads(1)
SMALL = ["--n", "6", "--max-len", "32", "--device", "cpu"]


def launch(capsys, *argv) -> list[str]:
    assert tserve.main([*argv, *SMALL]) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("mode,arch,row", [
    ("continuous", "granite-3-8b", "continuous  items=6"),
    ("chunked", "mamba2-780m", "chunked     items=6"),
    ("speculative", "whisper-tiny", "speculative items=6"),
])
def test_scheduler_modes_return_zero(capsys, mode, arch, row):
    out = launch(capsys, "--arch", arch, "--mode", mode, "--prefill-chunk", "4")
    assert out[0].startswith(f"{arch} on cpu: bursty stream, 6 requests, t_step=")
    assert out[1].strip().startswith(row), out
    assert out[2].strip().startswith("online tau after run:")


def test_strategies_mode_returns_zero(capsys):
    out = launch(capsys, "--arch", "whisper-tiny", "--mode", "strategies", "--trace", "bursty")
    assert out[0].startswith("whisper-tiny on cpu: measured batch latency")
    rows = [ln.split()[0] for ln in out[1:]]
    assert rows == ["on_off", "idle_waiting", "slow_down", "adaptive"]
    assert sum(ln.endswith(" *") for ln in out[1:]) == 1


def test_compare_paged_prints_the_paged_row_and_the_cache_bytes(capsys):
    out = launch(capsys, "--arch", "granite-3-8b", "--mode", "compare", "--paged")
    rows = [ln.split()[0] for ln in out[1:6] if not ln.strip().startswith("online")]
    assert rows == ["continuous", "chunked", "speculative", "static"]
    text = "\n".join(out)
    m = re.search(r"KV-cache HBM at parity sizing: contiguous ([\d.]+) MB vs paged ([\d.]+) MB "
                  r"\((\d+) pages of 16 rows\)", text)
    assert m and float(m[1]) > 0 and float(m[2]) > 0 and int(m[3]) > 1
    assert "paged preemption: preempted=" in text
    assert "continuous/static items-per-J:" in text
    assert "[paged]" not in text  # the main rows already ran paged


def test_compare_contiguous_adds_a_paged_row(capsys):
    out = launch(capsys, "--arch", "granite-3-8b", "--mode", "compare")
    assert any(ln.endswith("[paged]") and "items=6" in ln for ln in out)
    assert any("KV-cache HBM at parity sizing" in ln for ln in out)


def built(monkeypatch) -> list:
    """Record every scheduler the launcher builds."""
    made = []
    real = tserve.ContinuousBatchingScheduler

    def make(*args, **kw):
        made.append(real(*args, **kw))
        return made[-1]

    monkeypatch.setattr(tserve, "ContinuousBatchingScheduler", make)
    return made


def test_memory_pressure_and_power_flags_reach_the_scheduler(capsys, monkeypatch):
    made = built(monkeypatch)
    out = launch(capsys, "--arch", "granite-3-8b", "--paged", "--page-size", "4",
                 "--page-budget", "10", "--preempt-policy", "tiered", "--no-swap",
                 "--tier-mix", "0.5", "--fault-profile", "light", "--power-cap", "400",
                 "--brownout", "ladder", "--power-faults", "therm=0.1,thermf=0.5,thermt=24")
    (sched,) = made
    assert sched.preempter.order == "tiered" and sched.swap is False
    assert sched.pool.num_pages == 10 and sched.pool.page == 4
    assert sched.power.cap_w(0.0) == 400.0 and sched.brownout == "ladder"
    assert sched.faults.nan_rate > 0 and sched.faults.therm_rate == 0.1
    assert sched.faults.therm_frac == 0.5 and sched.faults.therm_ticks == 24
    row = out[1]  # a cap violation would print as capviol=N, N > 0
    assert "items=6" in row and "capviol=" not in row.replace("capviol=0", "")


def test_shedding_retry_and_budget_flags(capsys, monkeypatch):
    made = built(monkeypatch)
    out = launch(capsys, "--arch", "whisper-tiny", "--load", "flash", "--shed", "--deadline",
                 "0.05", "--retry-budget", "2", "--queue-limit", "3", "--energy-budget", "100",
                 "--budget-window", "0.5", "--quant-weights")
    (sched,) = made
    assert sched.shed and sched.queue_limit == 3 and sched.retry.max_restarts == 2
    assert sched.engine.sc.energy_budget_j == 100.0 and sched.engine.sc.budget_window_s == 0.5
    assert sched.engine.cfg.quant == "int8"
    assert out[0].startswith("whisper-tiny on cpu: flash stream, 6 requests")
    assert out[1].strip().startswith("continuous")


@pytest.mark.parametrize("argv,message", [
    (["--arch", "granite-3-8b", "--preempt-policy", "tiered"], "--preempt-policy requires"),
    (["--arch", "granite-3-8b", "--page-budget", "8"], "--page-budget requires"),
    (["--arch", "granite-3-8b", "--quant-kv"], "--quant-kv requires"),
    (["--arch", "granite-3-8b", "--brownout", "ladder"], "--brownout needs"),
    (["--arch", "no-such-arch"], "invalid choice"),
    (["--arch", "granite-3-8b", "--mode", "batch"], "invalid choice"),
    ([], "required"),
])
def test_bad_arguments_fail_as_the_references(capsys, argv, message):
    for main in (jserve.main, tserve.main):
        with pytest.raises(SystemExit) as err:
            main(argv)
        assert err.value.code == 2
        assert message in capsys.readouterr().err


def flags(main, monkeypatch) -> set[str]:
    """Every option string of the parser ``main`` builds."""
    seen = {}

    def grab(parser, *args, **kw):
        seen["parser"] = parser
        raise SystemExit(0)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            main([])
    return {o for action in seen["parser"]._actions for o in action.option_strings}


def test_every_flag_of_the_reference_and_device(monkeypatch):
    want = flags(jserve.main, monkeypatch)
    got = flags(tserve.main, monkeypatch)
    assert got == want | {"--device"}
    assert {"--paged", "--no-paged", "--swap", "--no-swap", "--energy-budget"} <= got


def test_the_default_device_is_the_card(monkeypatch):
    """Without ``--device`` the launcher asks for the card, and without one
    it raises rather than serve on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "granite-3-8b", "--n", "2"])
