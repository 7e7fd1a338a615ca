"""The port's fault-tolerant trainer (``repro_torch/train/trainer.py``)
and its launcher, on the CPU at reduced stablelm-1.6b: the reference's
trainer tests (``tests/test_serve_and_fault.py``) ported - restart and
recover, give up after ``max_restarts``, a resumed run equals an
uninterrupted one - plus the trainer against the reference's on the same
weights and data, and ``python -m repro_torch.launch.train``.

Tolerances: the port's own runs (resume, replay) are bit-equal; against
the JAX trainer the losses of 6 steps are within 1e-4 relative (float32,
the tolerances of tests/_torch_train_common.py, compounding over the
steps).
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.data import DataConfig as JDataConfig
from repro.models import build_model as j_build
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import Trainer as JTrainer
from repro.train import TrainerConfig as JTrainerConfig

from repro_torch import bridge
from repro_torch import tree as ttree
from repro_torch.configs import reduced_config
from repro_torch.data import DataConfig
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import trainer as ttrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_model():
    cfg = reduced_config("stablelm-1.6b")
    return cfg, build_model(cfg, "cpu")


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(ttree.leaves(a), ttree.leaves(b)))


def test_trainer_restarts_and_recovers(tmp_path, small_model):
    cfg, m = small_model
    boom = {"armed": True}

    def failure_hook(step):
        if step == 7 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected preemption")

    tr = Trainer(m, AdamWConfig(lr=1e-3), DataConfig(vocab=cfg.vocab, seq_len=16, batch=2),
                 TrainerConfig(total_steps=12, ckpt_every=5,
                               ckpt_dir=os.path.join(tmp_path, "ck"), log_every=1),
                 failure_hook=failure_hook)
    out = tr.train()
    assert out["restarts"] == 1
    assert out["history"][-1]["step"] == 12
    assert tr.ckpt.latest_step() == 12
    # the steps replayed from the step-5 checkpoint (6 and 7) give the same
    # losses, bit for bit, as before the failure
    by_step = {}
    for rec in out["history"]:
        by_step.setdefault(rec["step"], []).append(rec["loss"])
    assert [len(by_step[s]) for s in range(1, 13)] == [1] * 5 + [2, 2] + [1] * 5
    assert by_step[6][0] == by_step[6][1] and by_step[7][0] == by_step[7][1]


def test_trainer_gives_up_after_max_restarts(tmp_path, small_model):
    cfg, m = small_model

    def always_fail(step):
        raise RuntimeError("hard failure")

    tr = Trainer(m, AdamWConfig(), DataConfig(vocab=cfg.vocab, seq_len=16, batch=2),
                 TrainerConfig(total_steps=5, ckpt_every=100,
                               ckpt_dir=os.path.join(tmp_path, "ck2"), max_restarts=2),
                 failure_hook=always_fail)
    with pytest.raises(RuntimeError, match="max_restarts"):
        tr.train()
    assert tr.restarts == 3


def test_resume_from_checkpoint_is_exact(tmp_path, small_model):
    """Stop at 10 steps, resume to 20 == one uninterrupted 20-step run, bit
    for bit (the reference's test holds the final loss within 2e-3)."""
    cfg, m = small_model
    data = DataConfig(vocab=cfg.vocab, seq_len=16, batch=2, seed=3)
    opt = AdamWConfig(lr=1e-3)

    t1 = Trainer(m, opt, data, TrainerConfig(
        total_steps=10, ckpt_every=10, ckpt_dir=os.path.join(tmp_path, "a"), log_every=10))
    t1.train()
    t2 = Trainer(m, opt, data, TrainerConfig(
        total_steps=20, ckpt_every=10, ckpt_dir=os.path.join(tmp_path, "a"), log_every=10))
    out_resumed = t2.train()
    t3 = Trainer(m, opt, data, TrainerConfig(
        total_steps=20, ckpt_every=20, ckpt_dir=os.path.join(tmp_path, "b"), log_every=10))
    out_straight = t3.train()
    assert out_resumed["final_loss"] == out_straight["final_loss"]
    assert _leaves_equal(out_resumed["state"], out_straight["state"])
    # the restore alone gives the checkpointed state back, bit for bit
    state, step = Trainer(m, opt, data, TrainerConfig(
        total_steps=20, ckpt_dir=os.path.join(tmp_path, "b"))).restore_or_init()
    assert step == 20 and _leaves_equal(state, out_straight["state"])


@pytest.mark.parametrize("quant_state", [False, True])
def test_trainer_matches_the_reference_trainer(tmp_path, quant_state):
    """Six steps of both trainers from the same weights and data (the
    reference's ``make_state`` params carried into the port's
    ``fresh_state``): every logged loss within 1e-4 relative."""
    jcfg = j_reduced("stablelm-1.6b")
    jb = j_build(jcfg)
    jtr = JTrainer(jb, JAdamWConfig(lr=1e-3, quant_state=quant_state),
                   JDataConfig(vocab=jcfg.vocab, seq_len=16, batch=2),
                   JTrainerConfig(total_steps=6, ckpt_every=100, log_every=1,
                                  ckpt_dir=os.path.join(tmp_path, "j")))
    jout = jtr.train()
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0))),
                                      "cpu")
    cfg = reduced_config("stablelm-1.6b")
    m = build_model(cfg, "cpu")
    tr = Trainer(m, AdamWConfig(lr=1e-3, quant_state=quant_state),
                 DataConfig(vocab=cfg.vocab, seq_len=16, batch=2),
                 TrainerConfig(total_steps=6, ckpt_every=100, log_every=1,
                               ckpt_dir=os.path.join(tmp_path, "t")))
    fresh = tr.fresh_state
    tr.fresh_state = lambda: dict(fresh(), params=params)
    tout = tr.train()
    got = [r["loss"] for r in tout["history"]]
    want = [r["loss"] for r in jout["history"]]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert [r["step"] for r in tout["history"]] == list(range(1, 7))


def test_deterministic_scope_restores_the_setting():
    prev = torch.are_deterministic_algorithms_enabled()
    with ttrainer.deterministic("cpu"):
        assert torch.are_deterministic_algorithms_enabled()
    assert torch.are_deterministic_algorithms_enabled() == prev


def test_launch_train_end_to_end_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
           "--steps", "12", "--batch", "2", "--seq", "16", "--ckpt-every", "5",
           "--ckpt-dir", str(tmp_path / "ck")]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout)
    assert res["restarts"] == 0 and np.isfinite(res["final_loss"])
    assert [r["step"] for r in res["history"]] == [10, 12]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_10", "step_12", "step_5"]
    bad = subprocess.run(cmd + ["--mesh", "pod"], env=env, capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert bad.returncode != 0 and "no counterpart" in bad.stderr


def test_launch_train_over_a_mesh_prints_the_one_process_losses(tmp_path):
    """``--mesh 2x2 --num-processes 4``: four gloo processes, one a mesh
    entry, train the sharded step; rank 0 prints the JSON, whose losses
    are the one-process run's within 1e-5, and writes the checkpoints."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
           "--steps", "12", "--batch", "4", "--seq", "16", "--ckpt-every", "5"]
    runs = {}
    for name, extra in (("one", []), ("mesh", ["--mesh", "2x2", "--num-processes", "4"])):
        out = subprocess.run(cmd + ["--ckpt-dir", str(tmp_path / name)] + extra, env=env,
                             capture_output=True, text=True, timeout=300, cwd=tmp_path)
        assert out.returncode == 0, out.stderr[-2000:]
        runs[name] = json.loads(out.stdout)
        assert sorted(os.listdir(tmp_path / name)) == ["step_10", "step_12", "step_5"]
    got = [r["loss"] for r in runs["mesh"]["history"]]
    want = [r["loss"] for r in runs["one"]["history"]]
    assert [r["step"] for r in runs["mesh"]["history"]] == [10, 12]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    bad = subprocess.run(cmd + ["--mesh", "2x2", "--num-processes", "2"], env=env,
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert bad.returncode != 0 and "one process an entry" in bad.stderr
