"""Port parity: elastic recovery (``horovod_tpu_torch.elastic``), the fault
injector's ``ckpt:`` clauses and the Trainer's rollback against the JAX
package, on the CPU.

* ``ElasticState``: in a world of one, the JAX package's and the port's
  run the JAX drill's recurrence (``tests/elastic_worker.py``: ``grad_for``,
  f32 ``w``/``m``, ``max_to_keep`` 3) at ``commit_every`` 1 and 2 under
  ``ckpt:flip``, ``ckpt:truncate`` and ``ckpt:drop_marker`` at the last
  commit, and without a fault: the same committed steps, marker names and
  retention on disk, the same ``latest_committed()`` and
  ``discarded_corrupt`` from a fresh state, bitwise the same restored step
  and params, and manifests whose ``['params']`` records equal JAX's (the
  checkpoint bytes are each package's own format).
* The Trainer's rollback: JAX's ``test_trainer_raises_after_budget_
  without_elastic``, ``test_trainer_rolls_back_to_verified_elastic_step``
  and ``test_trainer_rollback_then_training_continues``
  (``tests/test_badstep_guard.py``) on both packages from the same MLP
  weights, data and NaN schedule: the same errors, the same rollback
  step, params within ``tests/test_hybrid.py``'s f32 tolerance (rtol
  2e-4, atol 1e-6) of JAX's and bitwise each side's own committed or
  reference state.
* The 2-rank gloo recovery drill through the port's launcher:
  ``rank=1:kill@step=3`` under ``--restarts 1`` ends with the FINAL lines
  of an uninterrupted run, whose params are bitwise the recurrence
  computed here.
* The two-phase commit: the ``ckpt:`` clauses fire after the marker,
  under a slow async writer the marker follows the bytes, a failed write
  leaves no marker; ZeRO state commits this rank's shard and restores at
  the same world size only; ``run_with_recovery``'s operator lines.
"""

import json
import os
import re
import subprocess
import sys
import time

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_elastic_worker as worker
from horovod_tpu import elastic as jelastic
from horovod_tpu import trainer as jtrainer
from horovod_tpu import training as jtraining
from horovod_tpu.exceptions import NonFiniteGradError as JNonFinite
from horovod_tpu.testing import faults as jfaults
from horovod_tpu_torch import elastic, runtime
from horovod_tpu_torch.exceptions import (CheckpointCorruptError,
                                          NonFiniteGradError,
                                          WorkerFailureError)
from horovod_tpu_torch.parallel import checkpoint as ckpt
from horovod_tpu_torch.testing import faults
from horovod_tpu_torch.trainer import AsyncCheckpointer, Trainer
from horovod_tpu_torch.training import create_train_state, make_train_step

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STEPS = 6
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-6   # tests/test_hybrid.py's f32 tolerance


@pytest.fixture
def world1(monkeypatch):
    for var in ("HVD_RANK", "HVD_SIZE", "HVD_LOCAL_RANK", "HVD_ZERO",
                "HVD_OVERLAP", "HVD_GUARD_NONFINITE", "HVD_WIRE_DTYPE",
                "HVD_MAX_BAD_STEPS", "HVD_FAULT_SPEC", "HVD_RESTART_EPOCH",
                "HVD_ELASTIC_DIR", "HVD_DEVICE"):
        monkeypatch.delenv(var, raising=False)
    faults.reset()
    jfaults.reset()
    runtime.init(device="cpu")
    yield
    runtime.shutdown()
    faults.reset()
    jfaults.reset()


# -- ElasticState against the JAX package's ---------------------------------

def _jax_drill(directory: str, commit_every: int):
    st = jelastic.ElasticState(
        {"w": jnp.zeros((8,), jnp.float32), "m": jnp.zeros((8,), jnp.float32)},
        opt_state=None, directory=directory, commit_every=commit_every)
    while st.step < STEPS:
        g = jnp.asarray(worker.grad_for(st.step, 0))
        st.params = {"w": st.params["w"] - 0.1 * g,
                     "m": st.params["m"] * 0.9 + g}
        st.advance()


def _port_drill(directory: str, commit_every: int):
    st = elastic.ElasticState(worker.Recurrence(), directory=directory,
                              commit_every=commit_every)
    while st.step < STEPS:
        worker.update(st.params, torch.from_numpy(worker.grad_for(st.step,
                                                                  0)))
        st.advance()


def _on_disk(directory: str):
    names = sorted(os.listdir(directory))
    return ([n for n in names if n.endswith(".committed")],
            [n for n in names if re.fullmatch(r"ckpt_\d+", n)])


def _params_records(path: str):
    with open(os.path.join(path, ckpt.MANIFEST_NAME)) as f:
        return [r for r in json.load(f)["leaves"]
                if r["path"].startswith("['params']")]


@pytest.mark.parametrize("commit_every,fault", [
    (1, "flip"), (2, "truncate"), (1, "drop_marker"), (2, None)])
def test_elastic_state_matches_jax(tmp_path, world1, monkeypatch,
                                   commit_every, fault):
    if fault:
        monkeypatch.setenv("HVD_FAULT_SPEC", f"ckpt:{fault}@step={STEPS}")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_drill(jdir, commit_every)
    _port_drill(tdir, commit_every)
    assert _on_disk(tdir) == _on_disk(jdir)
    kept = _on_disk(tdir)[1]
    assert len(kept) == 3 and kept[-1] == f"ckpt_{STEPS}"
    for name in kept:
        assert _params_records(os.path.join(tdir, name)) == \
            _params_records(os.path.join(jdir, name))

    jst = jelastic.ElasticState(
        {"w": jnp.ones((8,), jnp.float32), "m": jnp.ones((8,), jnp.float32)},
        directory=jdir)
    tst = elastic.ElasticState(worker.Recurrence(), directory=tdir)
    assert tst.latest_committed() == jst.latest_committed()
    assert tst.discarded_corrupt == jst.discarded_corrupt
    want = {None: STEPS, "drop_marker": STEPS - 1}.get(
        fault, STEPS - commit_every)
    assert tst.latest_committed() == want
    assert tst.discarded_corrupt == (2 if fault in ("flip", "truncate")
                                     else 0)
    jst.restore()
    tst.restore()
    assert tst.step == jst.step == want
    for k in ("w", "m"):
        np.testing.assert_array_equal(
            getattr(tst.params, k).detach().numpy(),
            np.asarray(jst.params[k]))


# -- the Trainer's rollback against the JAX package's ----------------------

class _JaxMLP(nn.Module):
    @nn.compact
    def __call__(self, x, train=True):
        return nn.Dense(10)(nn.relu(nn.Dense(16)(x)))


class _Dense(torch.nn.Module):
    def __init__(self, kernel, bias):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.tensor(np.asarray(kernel)))
        self.bias = torch.nn.Parameter(torch.tensor(np.asarray(bias)))

    def forward(self, x):
        return x @ self.kernel + self.bias


class _PortMLP(torch.nn.Module):
    """``_JaxMLP`` on flax's parameter names and layout (flax names the
    outer ``Dense(10)`` first: ``Dense_0``)."""

    def __init__(self, params):
        super().__init__()
        self.Dense_0 = _Dense(**params["Dense_0"])
        self.Dense_1 = _Dense(**params["Dense_1"])

    def forward(self, x, train=True):
        return self.Dense_0(torch.relu(self.Dense_1(x)))


def _jax_build():
    model = _JaxMLP()
    state, dist_opt = jtraining.create_train_state(
        model, jax.random.PRNGKey(0), jnp.zeros((2, 8)), optax.adam(1e-2))
    step = jtraining.make_train_step(model, dist_opt, guard_nonfinite=True,
                                     donate=False)
    return state, step


def _port_build(jax_state):
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    jax.device_get(jax_state.params))
    state = create_train_state(
        _PortMLP(params), lambda p: torch.optim.Adam(p, lr=1e-2,
                                                     foreach=False),
        device="cpu")
    return state, make_train_step(guard_nonfinite=True)


def _batch(rows=16, nan_at=None, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, 8).astype(np.float32)
    if nan_at is not None:
        x[nan_at] = np.nan
    return x, rng.randint(0, 10, (rows,))


def _nan_data(nbatches):
    return lambda: [_batch(nan_at=0, seed=i) for i in range(nbatches)]


def _port_params(state):
    return {n: p.detach().numpy().copy()
            for n, p in state.model.named_parameters()}


def _jax_params(state):
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(state.params))
    return {".".join(k.key for k in path): np.asarray(v)
            for path, v in flat[0]}


def _assert_close_to_jax(port, jax_):
    assert sorted(port) == sorted(jax_)
    for k in port:
        np.testing.assert_allclose(port[k], jax_[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def _flip_newest(path_port, path_jax):
    victim = faults._ckpt_data_file(path_port)
    off = faults._data_offset(victim) + 4
    with open(victim, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    victim = jfaults._ckpt_data_file(path_jax)
    with open(victim, "r+b") as f:
        f.seek(4)
        b = f.read(1)
        f.seek(4)
        f.write(bytes([b[0] ^ 0xFF]))


def test_trainer_raises_after_budget_without_elastic(world1):
    jstate, jstep = _jax_build()
    tstate, tstep = _port_build(jstate)
    heads = []
    for tr, err in ((Trainer(tstep, tstate, verbose=False, prefetch=0,
                             max_bad_steps=3), NonFiniteGradError),
                    (jtrainer.Trainer(jstep, jstate, verbose=False,
                                      prefetch=0, max_bad_steps=3),
                     JNonFinite)):
        with pytest.raises(err, match="3 consecutive") as e:
            tr.fit(_nan_data(8), epochs=1)
        heads.append(str(e.value))
    assert heads[0] == heads[1]


def test_trainer_rolls_back_to_verified_elastic_step(tmp_path, world1):
    jstate, jstep = _jax_build()
    tstate, tstep = _port_build(jstate)
    jes = jelastic.ElasticState(jstate.params, jstate.opt_state, step=0,
                                directory=str(tmp_path / "jax"),
                                commit_every=1)
    tes = elastic.ElasticState(tstate.model, tstate.optimizer, step=0,
                               directory=str(tmp_path / "port"),
                               commit_every=1)
    committed = {}
    for i in (1, 2):
        b = _batch(seed=10 + i)
        jstate, _ = jstep(jstate, b)
        jes.params, jes.opt_state, jes.step = (jstate.params,
                                               jstate.opt_state, i)
        jes.commit()
        tstate, _ = tstep(tstate, tuple(map(torch.from_numpy, b)))
        tes.step = i
        tes.commit()
        committed[i] = _port_params(tstate)
    _flip_newest(str(tmp_path / "port" / "ckpt_2"),
                 str(tmp_path / "jax" / "ckpt_2"))

    ttr = Trainer(tstep, tstate, verbose=False, prefetch=0, max_bad_steps=2,
                  elastic=tes)
    jtr = jtrainer.Trainer(jstep, jstate, verbose=False, prefetch=0,
                           max_bad_steps=2, elastic=jes)
    thist = ttr.fit(_nan_data(2), epochs=1)
    jhist = jtr.fit(_nan_data(2), epochs=1)
    assert thist[0]["bad_steps"] == jhist[0]["bad_steps"] == 2.0
    assert tes.discarded_corrupt == jes.discarded_corrupt == 1
    assert int(ttr.state.step) == int(jtr.state.step) == 1
    for k, v in _port_params(ttr.state).items():
        np.testing.assert_array_equal(v, committed[1][k])
    _assert_close_to_jax(_port_params(ttr.state), _jax_params(jtr.state))


def test_trainer_rollback_then_training_continues(tmp_path, world1):
    jstate, jstep = _jax_build()
    tstate, tstep = _port_build(jstate)
    ref_state, _ = _port_build(jstate)
    jes = jelastic.ElasticState(jstate.params, jstate.opt_state, step=0,
                                directory=str(tmp_path / "jax"))
    tes = elastic.ElasticState(tstate.model, tstate.optimizer, step=0,
                               directory=str(tmp_path / "port"))
    b42 = _batch(seed=42)
    jstate, _ = jstep(jstate, b42)
    jes.params, jes.opt_state, jes.step = jstate.params, jstate.opt_state, 1
    jes.commit()
    tstate, _ = tstep(tstate, tuple(map(torch.from_numpy, b42)))
    tes.step = 1
    tes.commit()
    # The reference trajectory: good step (seed 42) -> [rollback lands
    # here] -> good step (seed 2).
    for b in (b42, _batch(seed=2)):
        ref_state, _ = tstep(ref_state, tuple(map(torch.from_numpy, b)))

    def data():
        return [_batch(nan_at=0, seed=0), _batch(nan_at=0, seed=1),
                _batch(seed=2)]
    ttr = Trainer(tstep, tstate, verbose=False, prefetch=0, max_bad_steps=2,
                  elastic=tes)
    jtr = jtrainer.Trainer(jstep, jstate, verbose=False, prefetch=0,
                           max_bad_steps=2, elastic=jes)
    assert ttr.fit(data, epochs=1)[0]["bad_steps"] == 2.0
    assert jtr.fit(data, epochs=1)[0]["bad_steps"] == 2.0
    for k, v in _port_params(ttr.state).items():
        np.testing.assert_array_equal(v, _port_params(ref_state)[k])
    assert int(ttr.state.step) == int(jtr.state.step) == 2
    _assert_close_to_jax(_port_params(ttr.state), _jax_params(jtr.state))


def test_rollback_with_nothing_committed_raises_the_budget_error(
        tmp_path, world1):
    jstate, _ = _jax_build()
    tstate, tstep = _port_build(jstate)
    tes = elastic.ElasticState(tstate.model, tstate.optimizer,
                               directory=str(tmp_path))
    tr = Trainer(tstep, tstate, verbose=False, prefetch=0, max_bad_steps=2,
                 elastic=tes)
    with pytest.raises(NonFiniteGradError,
                       match="no verified committed checkpoint"):
        tr.fit(_nan_data(3), epochs=1)


# -- the 2-rank recovery drill through the launcher --------------------------

def _drill(tmp_path, name, fault=None):
    env = dict(os.environ, PYTHONPATH="", HVD_TOTAL_STEPS=str(STEPS),
               HVD_ELASTIC_DIR=str(tmp_path / name),
               HVD_RESTART_BACKOFF_MAX="0")
    if fault:
        env["HVD_FAULT_SPEC"] = fault
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.launcher", "-np", "2",
         "--cpu", "--restarts", "1" if fault else "0", sys.executable,
         os.path.join(HERE, "torch_elastic_worker.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


def _final(stdout: str):
    return dict(re.findall(r"rank (\d+)/\d+: (FINAL [0-9.]+ step \d+)",
                           stdout)), \
        dict(re.findall(r"rank (\d+)/\d+: PARAMS ([0-9a-f]+)", stdout))


def test_killed_rank_recovers_bitwise_to_an_uninterrupted_run(tmp_path):
    clean = _drill(tmp_path, "clean")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    faulty = _drill(tmp_path, "faulty", "rank=1:kill@step=3")
    assert faulty.returncode == 0, faulty.stdout + faulty.stderr
    assert "[elastic] world failure at step 3: worker failure" \
        in faulty.stderr, faulty.stderr
    assert faulty.stderr.count("tpurun: world failed") == 1
    assert "[elastic] recovery: resumed from committed step 3" \
        in faulty.stdout, faulty.stdout
    assert _final(faulty.stdout) == _final(clean.stdout)
    assert set(_final(clean.stdout)[0]) == {"0", "1"}
    # The recurrence here: the average of both ranks' pseudo-gradients.
    w = np.zeros(8, np.float32)
    m = np.zeros(8, np.float32)
    for s in range(STEPS):
        g = (worker.grad_for(s, 0) + worker.grad_for(s, 1)) / np.float32(2)
        w, m = w - np.float32(0.1) * g, m * np.float32(0.9) + g
    want = w.tobytes().hex() + m.tobytes().hex()
    assert _final(faulty.stdout)[1] == {"0": want, "1": want}


# -- the two-phase commit ---------------------------------------------------------

def _bumped(st):
    worker.update(st.params, torch.ones(8))
    st.step += 1


def test_ckpt_clauses_fire_after_the_marker(tmp_path, world1, monkeypatch):
    monkeypatch.setenv("HVD_FAULT_SPEC", "ckpt:flip@step=2")
    seen = []
    real = faults.ckpt_hook

    def spy(step, path, marker):
        seen.append((step, os.path.exists(marker), os.path.isdir(path)))
        real(step, path, marker)
    monkeypatch.setattr(faults, "ckpt_hook", spy)
    st = elastic.ElasticState(worker.Recurrence(), directory=str(tmp_path))
    for _ in range(2):
        _bumped(st)
        st.commit()
    assert seen == [(1, True, True), (2, True, True)]
    with pytest.raises(CheckpointCorruptError):
        ckpt.verify_checkpoint(str(tmp_path / "ckpt_2"))
    assert st.latest_committed() == 1 and st.discarded_corrupt == 1


def test_marker_follows_the_bytes_under_a_slow_writer(tmp_path, world1,
                                                      monkeypatch):
    real = ckpt.write_tree

    def slow(path, tree):
        time.sleep(0.3)
        real(path, tree)
    monkeypatch.setattr(ckpt, "write_tree", slow)
    with AsyncCheckpointer() as w:
        st = elastic.ElasticState(worker.Recurrence(),
                                  directory=str(tmp_path), writer=w)
        _bumped(st)
        st.commit()
        assert not os.path.exists(tmp_path / "ckpt_1.committed")
        assert st._local_latest() is None
        st.wait()
        assert os.path.exists(tmp_path / "ckpt_1.committed")
        ckpt.verify_checkpoint(str(tmp_path / "ckpt_1"))
        assert st.latest_committed() == 1


@pytest.mark.parametrize("async_", [False, True])
def test_failed_write_leaves_no_marker(tmp_path, world1, monkeypatch,
                                       async_):
    def broken(path, tree):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt, "write_tree", broken)
    w = AsyncCheckpointer() if async_ else None
    st = elastic.ElasticState(worker.Recurrence(), directory=str(tmp_path),
                              writer=w)
    _bumped(st)
    with pytest.raises(OSError, match="disk full"):
        st.commit()
        st.wait()
    if w is not None:
        w.close()
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".committed")]
    assert st.latest_committed() is None
    with pytest.raises(FileNotFoundError, match="no committed elastic state"):
        st.restore()


def test_explicit_step_is_verified(tmp_path, world1):
    st = elastic.ElasticState(worker.Recurrence(), directory=str(tmp_path))
    _bumped(st)
    st.commit()
    victim = faults._ckpt_data_file(str(tmp_path / "ckpt_1"))
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    with pytest.raises(CheckpointCorruptError):
        st.restore(step=1)


def test_zero_state_commits_this_ranks_shard(tmp_path, world1):
    import torch_dist_worker
    state = create_train_state(
        torch_dist_worker._MLP(), lambda p: torch.optim.Adam(
            p, lr=1e-2, foreach=False), zero=True, device="cpu")
    model, opt = state.model, state.optimizer
    step = make_train_step()
    x, y = _batch(rows=8)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    state, _ = step(state, batch)
    st = elastic.ElasticState(model, opt, step=1, directory=str(tmp_path))
    st.commit()
    with open(tmp_path / "ckpt_1" / ckpt.MANIFEST_NAME) as f:
        meta = json.load(f)
    assert meta["zero_rank"] == 0 and meta["world_size"] == 1
    want = [p.detach().clone() for p in model.parameters()]
    want_state = [{k: v.clone() for k, v in d.items()}
                  for d in opt.zero_state().inner]
    state, _ = step(state, batch)
    st.restore()
    for p, q in zip(model.parameters(), want):
        assert torch.equal(p, q)
    for d, e in zip(opt.zero_state().inner, want_state):
        assert sorted(d) == sorted(e)
        assert all(torch.equal(torch.as_tensor(d[k]), e[k]) for k in d)
    meta["world_size"] = 2
    with open(tmp_path / "ckpt_1" / ckpt.MANIFEST_NAME, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="same world size"):
        ckpt.restore_local(str(tmp_path), 1, model, opt, verify=False)


def test_run_with_recovery_resumes_and_exits_on_a_dead_peer(
        tmp_path, world1, capsys):
    st = elastic.ElasticState(worker.Recurrence(), directory=str(tmp_path))
    _bumped(st)
    st.commit()
    fresh = elastic.ElasticState(worker.Recurrence(), directory=str(tmp_path))

    def train(state):
        assert state.step == 1
        raise WorkerFailureError("worker failure: a peer closed")
    with pytest.raises(WorkerFailureError):
        elastic.run_with_recovery(train, fresh)
    out = capsys.readouterr()
    assert ("[elastic] recovery: resumed from committed step 1 (restore "
            "walk: discarded_corrupt=0, clean latest commit)") in out.out
    assert "[elastic] world failure at step 1: worker failure" in out.err
    assert not runtime.is_initialized()
    torch.testing.assert_close(fresh.params.w.detach(), st.params.w.detach(),
                               rtol=0, atol=0)
