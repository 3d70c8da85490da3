"""``python -m repro_torch.launch.train`` on the CPU: the plain loop and
the supervised loop with a failure, and the losses against the JAX
driver's on the same parameters and batches.

JAX's own CLI (``repro.launch.train``) raises on the jax this container
has (``with_sharding_constraint`` on an Explicit mesh), so the JAX side
here is that driver's loop without its mesh: the same ``TrainConfig``
(peak lr, warmup max(steps // 20, 2), cosine to ``steps``, remat
"nothing"), ``init_train_state`` at ``PRNGKey(0)`` and ``make_batch``.
Losses are held to rtol 1e-4 over 5 steps (f32; AdamW carries the
gradients' last-ulp differences from step to step).
"""
import jax
import numpy as np
import torch

from repro import configs as JCFG
from repro.data.synthetic import config_for as j_config_for
from repro.data.synthetic import make_batch as j_make_batch
from repro.train import AdamWConfig as JAdamW
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch import configs as TCFG
from repro_torch.launch.train import main, train
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import tree_leaves


def test_cli_runs_on_cpu(capsys):
    rep = main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "5",
                "--device", "cpu", "--log-every", "2"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[train]")]
    assert lines[0].startswith("[train] arch=qwen3-0.6b-smoke")
    assert sum(ln.startswith("[train] step ") for ln in lines) == 3
    assert "done: loss" in lines[-2]
    assert lines[-1] == ("[train] kernel launches: flash_attention fwd 0 bwd "
                         "0, selective_scan fwd 0 bwd 0")
    assert len(rep.losses) == 5 and np.isfinite(rep.losses).all()
    assert rep.losses[-1] < rep.losses[0]


def test_cli_supervised_run_resumes_exactly(tmp_path, capsys):
    args = ["--arch", "falcon-mamba-7b", "--smoke", "--steps", "6",
            "--batch", "2", "--seq", "16", "--device", "cpu"]
    plain = main(args)
    sup = main(args + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                       "--fail-at", "3"])
    assert "restarts=1" in capsys.readouterr().out
    assert sup.restarts == 1 and sup.steps_run == 7
    assert sup.losses == plain.losses
    for a, b in zip(tree_leaves(sup.state.params),
                    tree_leaves(plain.state.params)):
        assert torch.equal(a, b)


def test_losses_match_the_jax_driver():
    arch, steps, batch, seq = "qwen3-0.6b", 5, 8, 128
    jcfg = JCFG.get_smoke_config(arch)
    jtcfg = JTrainConfig(opt=JAdamW(peak_lr=3e-3,
                                    warmup_steps=max(steps // 20, 2),
                                    total_steps=steps))
    jstate = j_init_state(jcfg, jtcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                             TCFG.get_smoke_config(arch), device="cpu")
    scfg = j_config_for(jcfg, batch, seq)
    jstep = jax.jit(j_make_step(jcfg, jtcfg))
    want = []
    for s in range(steps):
        jstate, m = jstep(jstate, j_make_batch(scfg, s))
        want.append(float(m["loss"]))

    def batch_fn(s):
        return {k: torch.from_numpy(np.array(v))
                for k, v in j_make_batch(scfg, s).items()}

    rep = train(TCFG.get_smoke_config(arch), steps=steps, batch=batch,
                seq=seq, device="cpu", params=params, batch_fn=batch_fn,
                log=lambda line: None)
    np.testing.assert_allclose(rep.losses, want, rtol=1e-4)
