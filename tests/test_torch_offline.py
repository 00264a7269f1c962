"""The port's offline learner (``replay/offline.py``) against the JAX
package's, on the CPU.

One regularized update (``none``, ``bc``, ``cql``) at the sequence
policy's widths (d_model 64, 4 heads, 2 layers; history 8, batch 16)
from the JAX learner's initial state, carried over by ``weights.py``,
with the JAX update's draws injected: for ``none`` the critic and policy
noise of ``split(rng, 3)``; for ``bc``/``cql`` those of ``split(rng,
4)``, and for ``cql`` the K = 4 uniform proposals and the policy
action's noise from ``split(key_reg)``. Losses, the regularizers'
metrics, every gradient (the port's ``.grad`` against the JAX update's
first Adam moment over ``1 - b1``) and both Adam moments agree to the
update parity's 1e-5 / 1e-4, and every parameter does beyond what
Adam's first step makes of the gradients' own gap (``_adam_slack``:
nonzero only where a gradient sits near Adam's eps). The burst's batch indices
are the JAX package's from one seed, bitwise, and ``train_offline``
trains finite for every regularizer from a disk tier the JAX package
wrote (and one the port's trainer spilled), through the CLI to a
checkpoint that ``serve --run``'s read path loads.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_actor_critic_tpu import replay as jreplay
from torch_actor_critic_tpu.core.types import Batch as JBatch
from torch_actor_critic_tpu.replay import offline as joffline
from torch_actor_critic_tpu.utils.config import SACConfig as JSACConfig
from torch_actor_critic_tpu_torch import replay
from torch_actor_critic_tpu_torch.core.types import Batch
from torch_actor_critic_tpu_torch.envs.wrappers import ObsSpec
from torch_actor_critic_tpu_torch.replay import offline
from torch_actor_critic_tpu_torch.replay.offline import CQL_NUM_RANDOM, OfflineLearner
from torch_actor_critic_tpu_torch.utils.config import SACConfig
from torch_actor_critic_tpu_torch.weights import _adam_state, _named_arrays, train_state_from_jax

T, OBS_DIM, ACT_DIM, ACT_LIMIT, BATCH = 8, 3, 1, 2.0, 16
B1 = 0.9  # optax's and torch's Adam b1
SEQ = dict(history_len=T, seq_d_model=64, seq_num_heads=4, seq_num_layers=2, batch_size=BATCH)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    return dict(
        states=rng.standard_normal((BATCH, T, OBS_DIM)).astype(np.float32),
        actions=rng.uniform(-ACT_LIMIT, ACT_LIMIT, (BATCH, ACT_DIM)).astype(np.float32),
        rewards=rng.standard_normal(BATCH).astype(np.float32),
        next_states=rng.standard_normal((BATCH, T, OBS_DIM)).astype(np.float32),
        done=(rng.uniform(size=BATCH) < 0.25).astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def _jax_case(reg):
    """The JAX offline learner at ``reg``, its initial state and one
    jitted regularized update from it on ``_batch()``."""
    cfg = dict(SEQ, offline_reg=reg, offline_reg_weight=0.5, learn_alpha=True)
    jl = joffline.OfflineLearner(JSACConfig(**cfg), jax.ShapeDtypeStruct((T, OBS_DIM), jnp.float32),
                                 ACT_DIM, ACT_LIMIT)
    state = jax.jit(jl.init_state)(jax.random.PRNGKey(0))
    new, metrics = jax.jit(jl._offline_update)(state, JBatch(**_batch()))
    return state, new, metrics, SACConfig(**cfg)


def _draws(reg, rng_key):
    """The JAX update's draws: (eps_q, eps_pi) and for cql the
    proposals and the policy action's noise."""
    def normal(key):
        return torch.from_numpy(np.array(jax.random.normal(key, (BATCH, ACT_DIM))))

    if reg == "none":
        _, key_q, key_pi = jax.random.split(rng_key, 3)
        return dict(eps_q=normal(key_q), eps_pi=normal(key_pi))
    _, key_q, key_pi, key_reg = jax.random.split(rng_key, 4)
    out = dict(eps_q=normal(key_q), eps_pi=normal(key_pi))
    if reg == "cql":
        k_rand, k_pi = jax.random.split(key_reg)
        out["proposals"] = torch.from_numpy(np.array(jax.random.uniform(
            k_rand, (CQL_NUM_RANDOM, BATCH, ACT_DIM), minval=-ACT_LIMIT, maxval=ACT_LIMIT)))
        out["eps_cql"] = normal(k_pi)
    return out


LR, ADAM_EPS = 3e-4, 1e-8


def _adam_slack(module, jax_opt_state, scale=1.0):
    """Per parameter, what Adam's first step makes of the gap between the
    two gradients: ``scale · lr · |ĝ_port − ĝ_jax|`` with ``ĝ = g / (|g| +
    eps)``, the first step's direction (bias-corrected ``m / (sqrt(v) +
    eps)``). Where a gradient sits near Adam's eps (|g| ~ 1e-9 to 1e-8,
    six orders below its tensor's largest; an attention key bias's, zero
    in exact arithmetic, is all rounding noise) a gap of 1e-9 in ``g``,
    inside the gradients' own limit, moves the step by up to ``lr``;
    elsewhere this is ~0."""
    mu = _named_arrays(module, _adam_state(_np_tree(jax_opt_state)).mu)
    out = {}
    for name, p in module.named_parameters():
        g_port, g_jax = p.grad.numpy().astype(np.float64), mu[name] / (1 - B1)
        out[name] = scale * LR * np.abs(g_port / (np.abs(g_port) + ADAM_EPS)
                                        - g_jax / (np.abs(g_jax) + ADAM_EPS))
    return out


def _assert_close(module, tree, what, slack):
    want = _named_arrays(module, _np_tree(tree))
    for name, p in module.named_parameters():
        gap = np.abs(p.detach().numpy().astype(np.float64) - want[name])
        limit = 1e-5 + 1e-4 * np.abs(want[name]) + 1.01 * slack[name] + 1e-9
        assert (gap <= limit).all(), (
            f"{what}{name}: gap {gap.max()} over its limit at "
            f"{np.unravel_index((gap - limit).argmax(), gap.shape)}")


def _assert_grads_and_moments(module, opt, jax_opt_state, what):
    """Every gradient (the port's ``.grad`` against mu / (1 - b1) of the
    JAX update's first Adam step) and both Adam moments."""
    adam = _adam_state(_np_tree(jax_opt_state))
    mu, nu = _named_arrays(module, adam.mu), _named_arrays(module, adam.nu)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), mu[name] / (1 - B1), atol=1e-5, rtol=1e-4,
                                   err_msg=f"{what} grad {name}")
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), mu[name], atol=1e-5,
                                   rtol=1e-4, err_msg=f"{what} exp_avg {name}")
        np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(), nu[name], atol=1e-5,
                                   rtol=1e-4, err_msg=f"{what} exp_avg_sq {name}")


@pytest.mark.parametrize("reg", ["none", "bc", "cql"])
def test_one_regularized_update_matches_jax(reg):
    state, new, jm, cfg = _jax_case(reg)
    learner = OfflineLearner(cfg, ObsSpec((T, OBS_DIM)), ACT_DIM, ACT_LIMIT, device="cpu")
    st = train_state_from_jax(_np_tree(state), learner.sac, learner.state.actor,
                              learner.state.critic, torch.Generator())
    b = Batch(**{k: torch.from_numpy(v) for k, v in _batch().items()})
    st, tm = learner.update(st, b, **_draws(reg, state.rng))
    assert set(tm) == set(jm)
    keys = {"none": (), "bc": ("offline/bc_mse",), "cql": ("offline/cql_gap",)}[reg]
    for k in ("loss_q", "loss_pi", "q_mean", "backup_mean", "logp_pi", "alpha", *keys):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    if reg == "cql":
        assert float(tm["offline/cql_gap"]) != 0.0
    assert st.step == int(new.step) == 1
    _assert_grads_and_moments(st.critic, st.q_opt, new.q_opt_state, "critic")
    _assert_grads_and_moments(st.actor, st.pi_opt, new.pi_opt_state, "actor")
    q_slack = _adam_slack(st.critic, new.q_opt_state)
    _assert_close(st.actor, new.actor_params, "actor ",
                  _adam_slack(st.actor, new.pi_opt_state))
    _assert_close(st.critic, new.critic_params, "critic ", q_slack)
    _assert_close(st.target_critic, new.target_critic_params, "target ",
                  {k: (1 - cfg.polyak) * v for k, v in q_slack.items()})
    np.testing.assert_allclose(float(st.log_alpha.detach()), float(new.log_alpha),
                               atol=1e-6, rtol=0)


def test_cql_fold_is_the_per_candidate_critic():
    """The fold (one critic call over (K + 1)·B rows) against K + 1
    critic calls, one per candidate set, as the JAX ``vmap`` reads."""
    _, _, _, cfg = _jax_case("cql")
    learner = OfflineLearner(cfg, ObsSpec((T, OBS_DIM)), ACT_DIM, ACT_LIMIT, device="cpu")
    st = learner.state
    b = Batch(**{k: torch.from_numpy(v) for k, v in _batch(seed=9).items()})
    d = _draws("cql", jax.random.PRNGKey(4))
    with torch.no_grad():
        q_data = st.critic(b.states, b.actions)
        gap = learner._cql_gap(st, b, q_data, d["proposals"], d["eps_cql"])
        pi, _ = st.actor(b.states, eps=d["eps_cql"])
        q = torch.stack([st.critic(b.states, a) for a in [*d["proposals"], pi]])
        want = (torch.logsumexp(q, dim=0) - q_data).mean()
    np.testing.assert_allclose(float(gap), float(want), atol=1e-5, rtol=1e-5)


def test_stack_batches_indices_are_jax_bitwise():
    rng = np.random.default_rng(1)
    rows = {"states": rng.standard_normal((50, T, OBS_DIM)).astype(np.float32),
            "actions": rng.standard_normal((50, ACT_DIM)).astype(np.float32),
            "rewards": np.arange(50, dtype=np.float32),
            "next_states": rng.standard_normal((50, T, OBS_DIM)).astype(np.float32),
            "done": np.zeros(50, np.float32)}
    mine, theirs = np.random.default_rng(5), np.random.default_rng(5)
    for k in (3, 3, 1):  # the bursts of 7 steps at update_every 3
        got = offline._stack_batches(rows, mine, k, BATCH)
        want = joffline._stack_batches(rows, theirs, k, BATCH)
        assert got.rewards.shape == (k, BATCH)
        for name in ("states", "actions", "rewards", "next_states", "done"):
            np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)))


@pytest.fixture(scope="module")
def offline_dataset(tmp_path_factory):
    """The JAX test's dataset, written by the JAX package."""
    root = tmp_path_factory.mktemp("offline_ds") / "tier"
    tier = jreplay.DiskTier(root)
    tier.ensure_meta({"obs": {"kind": "flat", "shape": [OBS_DIM], "dtype": "float32"},
                      "act_dim": ACT_DIM, "act_limit": 1.0, "source": "test"})
    rng = np.random.default_rng(0)
    for i in range(2):
        ids = np.arange(64 * i, 64 * (i + 1), dtype=np.float32)
        states = np.zeros((64, OBS_DIM), np.float32)
        states[:, 0] = ids
        tier.append({"states": states, "actions": rng.uniform(-1, 1, (64, ACT_DIM))
                     .astype(np.float32), "rewards": -ids, "next_states": states + 1.0,
                     "done": np.zeros(64, np.float32)})
    tier.close()
    return root


@pytest.mark.parametrize("reg", ["none", "bc", "cql"])
def test_offline_trains_finite_for_every_regularizer(offline_dataset, reg):
    cfg = SACConfig(hidden_sizes=(16, 16), batch_size=16, update_every=3, offline=True,
                    offline_dataset=str(offline_dataset), offline_steps=7, offline_reg=reg,
                    offline_reg_weight=0.5)
    rows = []
    metrics = replay.train_offline(cfg, seed=0, device="cpu",
                                   on_epoch=lambda e, m: rows.append(m))
    # Bursts of 3, 3 and a shorter tail of 1.
    assert [r["offline/steps"] for r in rows] == [3.0, 6.0, 7.0]
    assert metrics["offline/steps"] == 7.0
    assert metrics["offline/dataset_rows"] == 128.0
    assert np.isfinite(metrics["loss_q"]) and np.isfinite(metrics["loss_pi"])
    if reg == "cql":
        assert np.isfinite(metrics["offline/cql_gap"]) and metrics["offline/cql_gap"] != 0.0
    if reg == "bc":
        assert np.isfinite(metrics["offline/bc_mse"]) and metrics["offline/bc_mse"] >= 0.0


def test_offline_cli_trains_from_the_trainers_spill_and_serves(tmp_path, capsys):
    """``train --replay-tiers disk`` spills a sequence run's rows; ``train
    --offline --offline-reg cql`` trains from them through the CLI, with
    telemetry; its checkpoint carries the JAX package's ``offline`` meta
    and restores through ``serve --run``'s read path and ``run_agent
    --run``."""
    from torch_actor_critic_tpu_torch import run_agent
    from torch_actor_critic_tpu_torch import train as train_cli
    from torch_actor_critic_tpu_torch.serve.__main__ import parse_arguments, resolve_model
    from torch_actor_critic_tpu_torch.utils.checkpoint import Checkpointer

    common = ["--environment", "PendulumNumpy-v1", "--history-len", "4", "--device", "cpu",
              "--seq-d-model", "16", "--seq-num-heads", "2", "--seq-num-layers", "1",
              "--batch-size", "16", "--runs-root", str(tmp_path / "runs")]
    train_cli.main(common + ["--epochs", "1", "--steps-per-epoch", "120", "--start-steps",
                             "40", "--update-after", "40", "--update-every", "20",
                             "--buffer-size", "50", "--replay-tiers", "disk",
                             "--replay-host-capacity", "20"])
    spill = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert spill["final"]["replay/spilled_disk_total"] > 0
    directory = tmp_path / "runs" / "Default" / spill["run"] / "replay"
    m = train_cli.main(common + ["--offline", "true", "--offline-dataset", str(directory),
                                 "--offline-reg", "cql", "--offline-steps", "5",
                                 "--update-every", "2", "--telemetry", "true"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert [json.loads(x)["offline/steps"] for x in lines[:-1]] == [2.0, 4.0, 5.0]
    assert np.isfinite(m["loss_q"]) and np.isfinite(m["offline/cql_gap"])
    meta = Checkpointer(last["checkpoint_dir"]).peek_meta()
    assert meta["offline"] == {"dataset": str(directory), "steps": 5, "reg": "cql"}
    events = [json.loads(x)["type"] for x in (tmp_path / "runs" / "Default" / last["run"]
                                              / "telemetry.jsonl").read_text().splitlines()]
    assert events.count("offline") == 3
    args = parse_arguments(["--run", last["run"], "--runs-root", str(tmp_path / "runs"),
                            "--device", "cpu"])
    actor_def, obs_spec, act_dim, _, ckpt_dir = resolve_model(args)
    params, _ = Checkpointer(ckpt_dir).restore_actor_params()
    actor_def.load_state_dict(params)
    assert tuple(obs_spec.shape) == (4, 3) and act_dim == 1
    evaluation = run_agent.main(["--run", last["run"], "--runs-root", str(tmp_path / "runs"),
                                 "--episodes", "1", "--seed", "0", "--device", "cpu"])
    assert np.isfinite(evaluation["ep_ret_mean"])
