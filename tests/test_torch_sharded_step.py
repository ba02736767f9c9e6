"""The port's sharded train step and ring attention's backward across ranks
against tpusnap's.

Two gloo worlds, started once for the module (their processes import
neither JAX nor tpusnap): four ranks, and one.

- Ring backward: dq, dk and dv of the port's ``ring_attention`` over rings
  of 2 (two sub-groups of the four ranks) and 4, causal and not, f32,
  against autograd of ``ring_attention_reference`` on the whole sequence
  at atol 1e-5 (tpusnap's own ring tolerance), and the backward's block
  steps and skips per rank.
- The loss across a ring of 2: its value under grad equals its value
  under ``no_grad`` bit for bit, and the ranks' gradients sum to the
  one-block model's on the whole sequence.
- The sharded step at tpusnap's default mesh for four devices,
  ``(data, fsdp, tensor) = (1, 2, 2)``, against tpusnap's
  ``make_train_step(jm, mesh)`` on four of conftest's CPU devices from the
  same initial parameters (``params_from_jax``): dense and MoE, with and
  without ring attention, f32 compute, 3 Adam steps: the losses within
  1e-4 relative, every rank's final boxes of the moments within the f32
  tolerance below and of the parameters under the gradient mask of
  ``tests/test_torch_moe.py``; the bf16 default (dense, with and without
  ring attention) with the losses within 2e-2 relative, the tolerance of
  tpusnap's ring-against-dense test.
- A mid-training snapshot of the sharded state (``tests/test_models.py``'s
  round trip and restore into another mesh shape): restored at
  ``(1, 2, 2)`` its next step equals the witness's bit for bit; restored
  at ``(1, 4, 1)``, a ring of 4, its loss is within 1e-4 relative.
- The step at mesh ``(1, 1, 1)`` (world of one) equals the one-replica
  ``Transformer.train_step`` bit for bit, losses and state, for the four
  families at the bf16 default.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

# One intra-op thread: the suite runs beside other test processes.
torch.set_num_threads(1)

_TINY = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128)
_TOKENS_SHAPE = (4, 32)
_LR = 1e-2
_STEPS = 3
_RING_SHAPE = (2, 16, 4, 8)  # b, global seq, h, d
# name -> (n_experts, use_ring_attention, f32 compute)
_CONFIGS = {
    "dense_noring_f32": (0, False, True),
    "dense_ring_f32": (0, True, True),
    "moe_noring_f32": (4, False, True),
    "moe_ring_f32": (4, True, True),
    "dense_noring_bf16": (0, False, False),
    "dense_ring_bf16": (0, True, False),
}
_SNAPSHOT_CONFIG = "dense_ring_f32"


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, value in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = value
    return out


def _tokens():
    return np.random.default_rng(1).integers(0, _TINY["vocab_size"], _TOKENS_SHAPE)


def _port_config(name: str):
    from tpusnap_torch.models import TransformerConfig

    n_experts, ring, f32 = _CONFIGS[name]
    extra = {"dtype": torch.float32} if f32 else {}
    return TransformerConfig(**_TINY, n_experts=n_experts, use_ring_attention=ring, **extra)


def _family(name: str) -> str:
    return "moe" if _CONFIGS[name][0] else "dense"


# ------------------------------------------------------------- world of 4


def _ring_backward_cases(data, arrays, scalars) -> None:
    """dq, dk, dv of this rank's block in rings of 2 and 4."""
    import importlib

    import torch.distributed as dist

    from tpusnap_torch.ops.ring_attention import ring_attention

    ra = importlib.import_module("tpusnap_torch.ops.ring_attention")
    rank = dist.get_rank()
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    for n, group in ((2, pairs[rank // 2]), (4, dist.group.WORLD)):
        r = dist.get_rank(group)
        blk = _RING_SHAPE[1] // n
        rows = slice(r * blk, (r + 1) * blk)
        for causal in (True, False):
            q, k, v = (torch.from_numpy(data[x][:, rows].copy()).requires_grad_(True)
                       for x in ("q", "k", "v"))
            steps0, skips0 = ra.backward_steps, ra.backward_skips
            out = ring_attention(q, k, v, group=group, causal=causal)
            with torch.no_grad():
                plain = ring_attention(q, k, v, group=group, causal=causal)
            out.backward(torch.from_numpy(data["dout"][:, rows].copy()))
            key = f"ring{n}/{causal}"
            for name, t in (("out", out.detach()), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
                arrays[f"{key}/{name}"] = t.numpy()
            scalars[key] = {"steps": ra.backward_steps - steps0, "skips": ra.backward_skips - skips0,
                            "grad_equals_no_grad": bool(torch.equal(out.detach(), plain))}


def _loss_across_ranks(tokens, arrays, scalars) -> None:
    """The ring loss over a ring of 2 under no_grad and under grad."""
    import torch.distributed as dist

    from tpusnap_torch.models import Transformer, TransformerConfig

    rank = dist.get_rank()
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    group = pairs[rank // 2]
    r = dist.get_rank(group)
    half = _TOKENS_SHAPE[1] // 2
    mine = tokens[:, r * half:(r + 1) * half].contiguous()
    cfg = TransformerConfig(**_TINY, use_ring_attention=True, dtype=torch.float32)
    model = Transformer(cfg, device="cpu", seed=3)
    with torch.no_grad():
        quiet = model.loss(mine, ring_group=group)
    loss = model.loss(mine, ring_group=group)
    loss.backward()
    scalars["loss_across_ranks"] = {"value": loss.item(), "no_grad_value": quiet.item(),
                                    "bitwise": bool(torch.equal(loss.detach(), quiet)),
                                    "requires_grad": loss.requires_grad}
    for path, p in _walk(model.params()):
        arrays[f"loss_grad/{path}"] = p.grad.numpy()


def _sharded_cases(data, tokens, arrays, scalars) -> None:
    from tpusnap_torch.models import Transformer, init_train_state, make_mesh, make_train_step

    mesh = make_mesh("cpu", (1, 2, 2))
    for name in _CONFIGS:
        family = _family(name)
        model = Transformer(_port_config(name), device="cpu", seed=0)
        model.params_from_jax(_nest({p[len(family) + 1:]: data[p] for p in data.files
                                     if p.startswith(family + "/")}))
        state = init_train_state(model, mesh)
        step = make_train_step(model, mesh, learning_rate=_LR)
        step.timed = step.keep_grads = True
        losses = [step(state, tokens).item()]
        for path, g in step.grads.items():
            arrays[f"{name}/grad1/{path}"] = g.numpy()
        step.keep_grads, step.grads = False, {}
        losses += [step(state, tokens).item() for _ in range(_STEPS - 1)]
        scalars[name] = {"losses": losses, "step": int(state["opt"]["step"].to_local()),
                         "split": sorted(step.split), "boxes": {}}
        for path, t in _walk(state):
            if path != "opt/step":
                arrays[f"{name}/{path}"] = t.to_local().numpy()
                scalars[name]["boxes"][path] = list(_box_offsets(t))


def _box_offsets(t):
    from tpusnap_torch.io_preparers.sharded import local_box

    mesh = t.device_mesh
    return local_box(list(t.shape), list(mesh.shape), mesh.get_coordinate(), t.placements)[0]


def _snapshot_case(data, tokens, out_dir, scalars) -> None:
    """Train 2 steps at (1, 2, 2), take, step 3 as the witness; restore
    into fresh states at (1, 2, 2) and (1, 4, 1) and take their step 3."""
    import torch.distributed as dist

    from tpusnap_torch import Snapshot, StateDict
    from tpusnap_torch.models import Transformer, init_train_state, make_mesh, make_train_step

    cfg = _port_config(_SNAPSHOT_CONFIG)
    mesh = make_mesh("cpu", (1, 2, 2))
    model = Transformer(cfg, device="cpu", seed=0)
    model.params_from_jax(_nest({p[len("dense/"):]: data[p] for p in data.files
                                 if p.startswith("dense/")}))
    state = init_train_state(model, mesh)
    step = make_train_step(model, mesh, learning_rate=_LR)
    for _ in range(2):
        step(state, tokens)
    path = os.path.join(out_dir, "snap")
    Snapshot.take(path, {"train": StateDict(**state)})
    taken = {p: t.to_local().clone() for p, t in _walk(state)}
    witness = step(state, tokens)

    fresh = Transformer(cfg, device="cpu", seed=9)
    fresh_state = init_train_state(fresh, mesh)
    Snapshot(path).restore({"train": StateDict(**fresh_state)})
    restored = all(torch.equal(t.to_local(), taken[p]) for p, t in _walk(fresh_state))
    again = make_train_step(fresh, mesh, learning_rate=_LR)(fresh_state, tokens)
    same_state = all(torch.equal(t.to_local(), u.to_local())
                     for (_, t), (_, u) in zip(_walk(fresh_state), _walk(state)))

    ring4 = make_mesh("cpu", (1, 4, 1))
    other = Transformer(cfg, device="cpu", seed=10)
    other_state = init_train_state(other, ring4)
    Snapshot(path).restore({"train": StateDict(**other_state)})
    resharded = make_train_step(other, ring4, learning_rate=_LR)(other_state, tokens)
    scalars["snapshot"] = {
        "restored_bitwise": restored, "witness": witness.item(), "again": again.item(),
        "again_bitwise": bool(torch.equal(again, witness)), "state_bitwise": same_state,
        "resharded": resharded.item(), "step": int(other_state["opt"]["step"].to_local()),
    }
    dist.barrier()


def _world4_rank(inputs: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = dist.get_rank()
    data = np.load(inputs)
    tokens = torch.from_numpy(data["tokens"])
    arrays, scalars = {}, {}
    _ring_backward_cases(data, arrays, scalars)
    _loss_across_ranks(tokens, arrays, scalars)
    _sharded_cases(data, tokens, arrays, scalars)
    _snapshot_case(data, tokens, out_dir, scalars)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(scalars, f)


def _world1_rank(out_dir: str) -> None:
    """Mesh (1, 1, 1): the sharded step beside ``train_step`` on a twin."""
    from tpusnap_torch.models import (
        Transformer,
        TransformerConfig,
        init_train_state,
        make_mesh,
        make_train_step,
    )

    torch.set_num_threads(1)
    tokens = torch.from_numpy(_tokens())
    mesh = make_mesh("cpu", (1, 1, 1))
    out = {}
    for n_experts in (0, 4):
        for ring in (False, True):
            cfg = TransformerConfig(**_TINY, n_experts=n_experts, use_ring_attention=ring)
            replica = Transformer(cfg, device="cpu", seed=0)
            sharded = Transformer(cfg, device="cpu", seed=0)
            state = init_train_state(sharded, mesh)
            step = make_train_step(sharded, mesh, learning_rate=_LR)
            losses = [(replica.train_step(tokens, learning_rate=_LR), step(state, tokens))
                      for _ in range(_STEPS)]
            out[f"experts={n_experts},ring={ring}"] = {
                "losses_bitwise": all(torch.equal(a, b) for a, b in losses),
                "state_bitwise": all(
                    torch.equal(t, dict(_walk(state))[p].to_local())
                    for p, t in _walk(replica.train_state())
                ),
            }
    with open(os.path.join(out_dir, "world1.json"), "w") as f:
        json.dump(out, f)


# ------------------------------------------------------------- the parent


def _jax_runs(tokens):
    """tpusnap's initial params by family, and per config its 3 losses,
    final state, the per-step gradients' smallest magnitude and step 1's
    gradients."""
    import jax
    import jax.numpy as jnp

    from tpusnap.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
        init_train_state,
        make_mesh,
        make_train_step,
    )

    mesh = make_mesh(jax.devices()[:4], (1, 2, 2))
    toks = jnp.asarray(tokens, jnp.int32)
    params, runs = {}, {}
    for name, (n_experts, ring, f32) in _CONFIGS.items():
        extra = {"dtype": jnp.float32} if f32 else {}
        jm = JaxTransformer(JaxConfig(**_TINY, n_experts=n_experts, use_ring_attention=ring, **extra))
        state = init_train_state(jm, mesh, jax.random.PRNGKey(0))
        params.setdefault(_family(name), dict(_walk(jax.tree.map(np.asarray, state["params"]))))
        step = make_train_step(jm, mesh, learning_rate=_LR)
        grad = jax.jit(jax.grad(functools.partial(jm.loss, mesh=mesh)))
        losses, small, first = [], None, None
        for _ in range(_STEPS):
            if f32:
                g = {p: np.asarray(x) for p, x in _walk(grad(state["params"], toks))}
                first = g if first is None else first
                g = {p: np.abs(x) for p, x in g.items()}
                small = g if small is None else {p: np.minimum(small[p], g[p]) for p in g}
            state, loss = step(state, toks)
            losses.append(float(loss))
        runs[name] = (losses, dict(_walk(jax.tree.map(np.asarray, state))), small, first)
    return params, runs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from tpusnap_torch.test_utils import run_subprocess_world

    root = tmp_path_factory.mktemp("sharded_step")
    tokens = _tokens()
    params, runs = _jax_runs(tokens)
    rng = np.random.default_rng(11)
    ring_inputs = {x: rng.standard_normal(_RING_SHAPE).astype(np.float32)
                   for x in ("q", "k", "v", "dout")}
    inputs = str(root / "inputs.npz")
    flat = {f"{family}/{p}": a for family, tree in params.items() for p, a in tree.items()}
    np.savez(inputs, tokens=tokens, **ring_inputs, **flat)
    env = {"TPUSNAP_TELEMETRY_DIR": str(root / "telemetry")}
    out4 = root / "world4"
    out4.mkdir()
    run_subprocess_world(_world4_rank, 4, args=[inputs, str(out4)], timeout=300, extra_env=env)
    ranks = [(dict(np.load(out4 / f"rank{r}.npz")), json.loads((out4 / f"rank{r}.json").read_text()))
             for r in range(4)]
    out1 = root / "world1"
    out1.mkdir()
    run_subprocess_world(_world1_rank, 1, args=[str(out1)], timeout=300, extra_env=env)
    world1 = json.loads((out1 / "world1.json").read_text())
    return {"tokens": tokens, "ring_inputs": ring_inputs, "runs": runs, "ranks": ranks,
            "world1": world1}


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_backward_matches_whole_sequence_autograd(worlds, n, causal):
    from tpusnap_torch.ops.ring_attention import ring_attention_reference

    q, k, v, dout = (torch.from_numpy(worlds["ring_inputs"][x]) for x in ("q", "k", "v", "dout"))
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ring_attention_reference(q, k, v, causal=causal)
    want = dict(zip(("dq", "dk", "dv"), torch.autograd.grad(out, (q, k, v), dout)))
    want["out"] = out.detach()
    key = f"ring{n}/{causal}"
    for name, full in want.items():
        got = np.concatenate([worlds["ranks"][r][0][f"{key}/{name}"] for r in range(n)], axis=1)
        np.testing.assert_allclose(got, full.numpy(), atol=1e-5, err_msg=f"{name}, ring of {n}")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_backward_skips_future_blocks_and_keeps_the_forward(worlds, n, causal):
    # Group rank r computes blocks 0..r when causal (n - 1 - r rotate past),
    # every block otherwise; the output under grad is the no_grad ring's.
    for rank in range(4):
        r = rank % n
        got = worlds["ranks"][rank][1][f"ring{n}/{causal}"]
        want_steps = r + 1 if causal else n
        assert (got["steps"], got["skips"]) == (want_steps, n - want_steps), (rank, got)
        assert got["grad_equals_no_grad"], rank


def test_loss_across_ranks_keeps_its_value_and_has_a_gradient(worlds):
    from tpusnap_torch.models import Transformer, TransformerConfig

    ranks = worlds["ranks"]
    for arrays, scalars in ranks:
        got = scalars["loss_across_ranks"]
        assert got["requires_grad"] and got["bitwise"], got
    cfg = TransformerConfig(**_TINY, use_ring_attention=True, dtype=torch.float32)
    model = Transformer(cfg, device="cpu", seed=3)
    loss = model.loss(torch.from_numpy(worlds["tokens"]))
    loss.backward()
    for rank in (0, 2):
        np.testing.assert_allclose(ranks[rank][1]["loss_across_ranks"]["value"], loss.item(),
                                   rtol=1e-5)
    for path, p in _walk(model.params()):
        for pair in ((0, 1), (2, 3)):
            summed = sum(ranks[r][0][f"loss_grad/{path}"] for r in pair)
            np.testing.assert_allclose(summed, p.grad.numpy(), atol=1e-5, err_msg=path)


def _jax_box(full: np.ndarray, offsets, shape) -> np.ndarray:
    return full[tuple(slice(o, o + n) for o, n in zip(offsets, shape))]


@pytest.mark.parametrize("name", [n for n in _CONFIGS if n.endswith("_f32")])
def test_sharded_step_matches_tpusnaps_at_1_2_2(worlds, name):
    want_losses, want_state, small, _ = worlds["runs"][name]
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        got = scalars[name]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4, err_msg=f"rank {rank}")
        assert got["step"] == _STEPS
        for path, offsets in got["boxes"].items():
            box = arrays[f"{name}/{path}"]
            want = _jax_box(want_state[path], offsets, box.shape)
            msg = f"{name} rank {rank} {path}"
            if path.startswith("opt/mu"):
                # Moments are sums of f32 gradients that the two packages
                # add in other orders: 1e-4 relative of the largest.
                np.testing.assert_allclose(box, want, atol=1e-4 * np.abs(want).max(), err_msg=msg)
            elif path.startswith("opt/nu"):
                np.testing.assert_allclose(box, want, atol=1e-4 * np.abs(want).max(), err_msg=msg)
            else:
                # Adam moves a weight by about lr * sign(g) where |g| >> eps;
                # where a step's |g| is near eps its last bits decide. So:
                # where every step's |g| > 1e-6, each step within 1/1000 of
                # lr (the one-step tests' 1e-6 at lr 1e-3), so 3 steps
                # within 3/1000 of lr.
                big = _jax_box(small[path[len("params/"):]], offsets, box.shape) > 1e-6
                np.testing.assert_allclose(box[big], want[big], atol=_STEPS * 1e-3 * _LR,
                                           err_msg=msg)
                assert np.abs(box - want).max() <= 2 * _STEPS * _LR, msg


@pytest.mark.parametrize("name", [n for n in _CONFIGS if n.endswith("_f32")])
def test_sharded_step_gradients_match_tpusnaps(worlds, name):
    # Step 1's full gradient (summed over data x fsdp) on every rank
    # against jax.grad of the global mean loss, at the 1e-5 of the
    # one-process gradient tests.
    want = worlds["runs"][name][3]
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        assert scalars[name]["split"] == sorted(["gather", "forward", "backward", "reduce", "update"])
        for path, g in want.items():
            np.testing.assert_allclose(arrays[f"{name}/grad1/{path}"], g, atol=1e-5,
                                       err_msg=f"{name} rank {rank} {path}")


@pytest.mark.parametrize("name", [n for n in _CONFIGS if n.endswith("_bf16")])
def test_sharded_step_bf16_losses_match_tpusnaps(worlds, name):
    want_losses = worlds["runs"][name][0]
    for arrays, scalars in worlds["ranks"]:
        np.testing.assert_allclose(scalars[name]["losses"], want_losses, rtol=2e-2)
    assert want_losses[-1] < want_losses[0]


def test_ranks_agree_on_the_loss(worlds):
    for name in _CONFIGS:
        losses = [scalars[name]["losses"] for _, scalars in worlds["ranks"]]
        assert all(x == losses[0] for x in losses), (name, losses)


def test_mid_training_snapshot_restores_at_both_meshes(worlds):
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        got = scalars["snapshot"]
        assert got["restored_bitwise"], (rank, got)
        assert got["again_bitwise"] and got["state_bitwise"], (rank, got)
        assert got["step"] == 3
        np.testing.assert_allclose(got["resharded"], got["witness"], rtol=1e-4, err_msg=f"rank {rank}")


@pytest.mark.parametrize("family", ["experts=0,ring=False", "experts=0,ring=True",
                                    "experts=4,ring=False", "experts=4,ring=True"])
def test_step_at_1_1_1_is_train_step_bit_for_bit(worlds, family):
    got = worlds["world1"][family]
    assert got["losses_bitwise"] and got["state_bitwise"], got

