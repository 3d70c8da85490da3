"""The port's serving engine against JAX ``make_serve_step`` on the same
weights and prompts, greedy: generated tokens and slot state (``position``,
``active``, ``n_generated``, ``in_prompt``, ``last_token``) exact after
every step.  Mirrors the four cases of ``test_serve.py``, and runs the
port's ``launch.serve`` driver on the CPU."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.models import model as JM
from repro.serve import ServeConfig as JServeConfig
from repro.serve import init_server as j_init_server
from repro.serve import make_serve_step as j_make_serve_step
from repro.serve import submit as j_submit
from repro_torch import configs as TCFG
from repro_torch.launch import serve as launch_serve
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (ServeConfig, init_server, make_serve_step,
                               submit)

FIELDS = ("generated", "position", "active", "n_generated", "in_prompt",
          "last_token")


class Pair:
    """The JAX server and the port's, driven in lock step."""

    def __init__(self, arch="qwen1.5-0.5b", slots=4):
        jcfg = JCFG.get_smoke_config(arch)
        tcfg = TCFG.get_smoke_config(arch)
        params = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
        self.j = j_init_server(jcfg, JServeConfig(slots=slots, max_seq=64,
                                                  eos_token=1),
                               prompt_max=8, gen_max=8)
        self.t = init_server(tcfg, ServeConfig(slots=slots, max_seq=64,
                                               eos_token=1),
                             prompt_max=8, gen_max=8, device="cpu")
        self.jstep = j_make_serve_step(jcfg, JServeConfig(
            slots=slots, max_seq=64, eos_token=1), params)
        self.tstep = make_serve_step(tcfg, ServeConfig(
            slots=slots, max_seq=64, eos_token=1), tparams)

    def submit(self, slot, prompt, max_new):
        self.j = j_submit(self.j, slot, np.asarray(prompt), max_new)
        self.t = submit(self.t, slot, np.asarray(prompt), max_new)
        self.check()

    def step(self, n=1):
        for _ in range(n):
            self.j, jtok = self.jstep(self.j, jax.random.PRNGKey(0))
            self.t, ttok = self.tstep(self.t)
            assert np.array_equal(np.asarray(jtok), ttok.numpy())
            self.check()

    def check(self):
        for f in FIELDS:
            want = np.asarray(getattr(self.j, f))
            got = getattr(self.t, f).numpy()
            assert got.dtype == want.dtype, f
            assert np.array_equal(got, want), (f, got, want)

    def field(self, name):
        return getattr(self.t, name)


def test_greedy_matches_jax_server():
    pair = Pair()
    pair.submit(0, [5, 9, 3], max_new=4)
    pair.step(3 + 4)
    assert int(pair.field("n_generated")[0]) >= 1


def test_budget_frees_slot():
    pair = Pair()
    pair.submit(1, [7, 8], max_new=3)
    pair.step(2 + 3 + 1)
    assert not bool(pair.field("active")[1])
    assert int(pair.field("n_generated")[1]) <= 3


def test_slot_reuse_after_completion():
    pair = Pair()
    pair.submit(0, [4, 4], max_new=2)
    pair.step(6)
    assert not bool(pair.field("active")[0])
    pair.submit(0, [9], max_new=2)
    assert bool(pair.field("active")[0])
    assert int(pair.field("position")[0]) == 0
    pair.step(4)
    assert int(pair.field("n_generated")[0]) >= 1


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "h2o-danube-1.8b",
                                  "falcon-mamba-7b", "moonshot-v1-16b-a3b",
                                  "qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b"])
def test_continuous_batching_mixed_phases(arch):
    """Slots at different positions advance in one batched step (SWA ring
    and Mamba state included)."""
    pair = Pair(arch)
    pair.submit(0, [3, 5, 7, 9], max_new=4)
    pair.step()                          # slot0 mid-prompt
    pair.submit(2, [2], max_new=4)       # join late
    pair.step(8)
    assert int(pair.field("n_generated")[0]) >= 1
    assert int(pair.field("n_generated")[2]) >= 1
    assert int(pair.field("position")[0]) != int(pair.field("position")[2])


def test_submit_refuses_busy_slot():
    pair = Pair()
    pair.submit(0, [3, 4], max_new=2)
    with pytest.raises(ValueError, match="busy"):
        submit(pair.t, 0, np.array([1]), 2)


def test_sampling_uses_the_generator():
    cfg = TCFG.get_smoke_config("qwen1.5-0.5b")
    from repro_torch.models import model as TM
    params = TM.init_params(cfg, device="cpu")
    scfg = ServeConfig(slots=2, max_seq=32, temperature=1.0)
    step = make_serve_step(cfg, scfg, params)
    outs = []
    for _ in range(2):
        state = submit(init_server(cfg, scfg, prompt_max=4, gen_max=8,
                                   device="cpu"), 0, np.array([3]), 8)
        gen = torch.Generator().manual_seed(5)
        toks = [step(state, gen)[1] for _ in range(4)]
        outs.append(torch.stack(toks))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b",
                                  "musicgen-large", "moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b"])
def test_launch_serve_drains_on_cpu(arch, capsys):
    report = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                                "--requests", "5", "--slots", "2",
                                "--max-new", "6"])
    assert report.completed == 5
    assert not bool(report.state.active.any())
    assert "[serve] 5 requests" in capsys.readouterr().out
