"""Tensor-parallel training (``repro_torch.distributed.world.TPTrainer``) on
the CPU, against the JAX reference.

One gloo world per size (2 and 4 ranks) shared by the module's cases, as
in ``tests/test_torch_tp_kinds.py``.  At f32 compute and smoke width, with
the reference's parameters carried across by ``interop.from_reference``,
llama3.2-3b, granite-moe-1b-a400m (dropless, and at a capacity factor of
0.5, where pairs drop and the aux loss sees them), deepseek-v3-671b (MLA,
MoE, MTP), rwkv6-7b and recurrentgemma-9b at tp 2, and llama3.2-3b at tp 4
(its 2 kv heads do not divide 4: the fallback's narrowings):

- every rank's loss within 1e-5 relative of ``jax.value_and_grad`` of the
  reference's ``configs.base.loss_fn``; each leaf's gradient, the ranks'
  cuts put together, within 1e-4 of its max |grad|, a gradient for every
  leaf the layers read whole; one global norm, the same bits on every
  rank; the parameters after one ``train_step`` within 2 lr of the
  reference's ``apply_updates`` (a sanity bound only: AdamW's first step
  moves each element by about lr whatever the gradient);
- the optimizer over the world on its own: fed the reference's gradients
  of three steps (each at the reference's parameters of that step, so the
  moments no longer reduce to the gradient's sign), cut to each rank's
  slice, the parameters within 1e-2 lr of the reference's ``apply_updates``
  fed the same (jitted: XLA's fusions round f32 unlike op by op, a few
  ulp of each parameter; a flipped or lost update moves an element by
  about lr), the global norms within 1e-5 relative and the same bits on
  every rank;
- the invariants: replicated leaves and kept wholes the same digest on
  every rank, each cut the slice of its kept whole bit for bit, the
  backward's collectives counted;
- a tp-2 checkpoint restores on one device (``Trainer.try_restore``) as
  the whole of the ranks' cuts, into a world (``CheckpointParams``) as
  each rank's cut, and a resumed tp-2 run continues bit for bit against
  an uninterrupted one;
- 8-bit moments are refused over a world before any collective, and a
  step that raises after a backward collective breaks the world.

About 50 s alone in one process.
"""

import dataclasses

import _torch_tp_ranks as ranks
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import base as jbase
from repro.nn import init as jinit
from repro.train import optimizer as jopt
from repro_torch import interop
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import ARCHS
from repro_torch.configs import base as cbase
from repro_torch.data.tokens import TokenPipelineConfig
from repro_torch.distributed import world as W
from repro_torch.nn import init as nninit
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(2)

TIMEOUT_S = 30.0
LOSS_RTOL, GRAD_TOL, LR = 1e-5, 1e-4, 1e-3
FED_STEPS, FED_TOL = 3, 1e-2    # steps of the fed optimizer; its bound in lr
OPT = dict(lr=LR, warmup_steps=1, total_steps=10)
#: (case, arch, tp): granite at its smoke capacity factor, n_experts / top_k
#: (dropless), and at 0.5, where pairs drop
CASES = [("llama3.2-3b", "llama3.2-3b", 2), ("granite-dropless", "granite-moe-1b-a400m", 2),
         ("granite-drops", "granite-moe-1b-a400m", 2), ("deepseek", "deepseek-v3-671b", 2),
         ("rwkv", "rwkv6-7b", 2), ("griffin", "recurrentgemma-9b", 2),
         ("llama3.2-3b-tp4", "llama3.2-3b", 4)]


def _f32(cfg, case: str, dtype):
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    if case == "granite-drops":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    return cfg


def _models(case: str, arch_id: str, seed: int):
    jcfg = _f32(JARCHS[arch_id].make_smoke(), case, jnp.float32)
    cfg = _f32(ARCHS[arch_id].make_smoke(), case, torch.float32)
    jp = jinit.materialize(jbase.model_spec(JARCHS[arch_id], jcfg), jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, interop.from_reference(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(vocab: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (2, 16)).astype(np.int32) for k in ("tokens", "targets")}


def _data(cfg) -> TokenPipelineConfig:
    return TokenPipelineConfig(vocab_size=cfg.vocab, seq_len=16, global_batch=2, seed=5)


def _whole(cuts: list, dim):
    return cuts[0] if dim is None else torch.cat(cuts, dim=dim)


@pytest.fixture(scope="module")
def worlds():
    opened: dict[int, W.World] = {}

    def get(tp: int) -> W.World:
        if tp not in opened:
            opened[tp] = W.World(("cpu",) * tp, timeout_s=TIMEOUT_S)
        return opened[tp]

    yield get
    for w in opened.values():
        procs = list(w._procs)
        w.close()
        assert not any(p.is_alive() for p in procs)


@pytest.mark.parametrize("case, arch_id, tp", CASES, ids=[c for c, _, _ in CASES])
def test_tp_step_matches_reference(worlds, tmp_path, case, arch_id, tp):
    seed = [c for c, _, _ in CASES].index(case)
    jcfg, cfg, jp, p = _models(case, arch_id, seed)
    batch = _batch(cfg.vocab, seed)
    jvg = jax.jit(jax.value_and_grad(jbase.loss_fn(JARCHS[arch_id], jcfg)))
    jocfg = jopt.AdamWConfig(**OPT)
    jstep = jax.jit(lambda p, g, st: jopt.apply_updates(p, g, st, jocfg))
    jbatch = jax.tree.map(jnp.asarray, batch)
    jloss, jgrads = jvg(jp, jbatch)
    jp1, jst, jm = jstep(jp, jgrads, jopt.init_state(jp, jocfg))
    # the reference's gradient at each of FED_STEPS steps' parameters
    fed_g, fed_norms, jp_k = [jgrads], [float(jm["grad_norm"])], jp1
    for _ in range(FED_STEPS - 1):
        fed_g.append(jvg(jp_k, jbatch)[1])
        jp_k, jst, m_k = jstep(jp_k, fed_g[-1], jst)
        fed_norms.append(float(m_k["grad_norm"]))
    spec = cbase.model_spec(ARCHS[arch_id], cfg)    # the ranks' leaf order

    def leaves(tree):
        port = interop.from_reference(jax.tree.map(np.asarray, tree), "cpu")
        return tree_leaves(tree_map(lambda _, t: t, spec, port))

    want_g, want_p, want_fed = leaves(jgrads), leaves(jp1), leaves(jp_k)

    trainer = W.TPTrainer(worlds(tp), W.EngineSpec(arch_id, cfg, W.GivenParams(p), None,
                                                   W.TrainSpec(TrainerConfig(ckpt_dir=str(tmp_path)),
                                                               opt.AdamWConfig(**OPT), _data(cfg))),
                          owns_world=False)
    fed = trainer.on_every_rank(ranks.fed_updates, [leaves(g) for g in fed_g])
    fed = [fed[0], *fed[1]]
    mine, theirs = trainer.on_every_rank(
        ranks.grads_then_step, {k: torch.from_numpy(v) for k, v in batch.items()})
    every = [mine, *theirs]
    for r in every:
        assert abs(r["loss"] - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
        assert r["grad_norm"] == mine["grad_norm"] and r["digests"] == mine["digests"]
        assert r["slices"] and r["dims"] == mine["dims"]
    assert mine["loss"] == theirs[0]["loss"]
    np.testing.assert_allclose(mine["grad_norm"], float(jm["grad_norm"]), rtol=1e-5)
    for r in fed:
        assert r["norms"] == fed[0]["norms"] and r["digests"] == fed[0]["digests"]
        assert r["slices"]
    np.testing.assert_allclose(fed[0]["norms"], fed_norms, rtol=1e-5)
    assert mine["n_whole"] > 0
    assert mine["phases"]["backward"].get("copy_in", 0) > 0
    assert mine["phases"]["optimizer"]["global_norm"] == 1
    assert mine["phases"]["optimizer"]["refresh_whole"] >= 1
    if tp == 4:
        assert mine["phases"]["backward"].get("take_local", 0) > 0
    if arch_id == "recurrentgemma-9b":
        assert mine["phases"]["forward"]["reduce_scatter"] > 0
        assert mine["phases"]["backward"]["reduce_scatter_grad"] > 0

    assert len(want_g) == len(mine["grads"])
    for i, (w, dim) in enumerate(zip(want_g, mine["dims"])):
        cuts = [r["grads"][i] for r in every]
        if all(c is None for c in cuts):
            assert float(w.abs().max()) == 0.0, f"leaf {i}: no gradient"
            continue
        got = _whole(cuts, dim)
        assert got.shape == w.shape
        assert float((got - w).abs().max()) <= GRAD_TOL * max(float(w.abs().max()), 1e-30), i
        got_p = _whole([r["params"][i] for r in every], dim)
        assert float((got_p - want_p[i]).abs().max()) <= 2 * LR, i
    for i, (w, dim) in enumerate(zip(want_fed, mine["dims"])):
        got = _whole([r["params"][i] for r in fed], dim)
        assert float((got - w).abs().max()) <= FED_TOL * LR, i
    trainer.close()


def test_tp_checkpoint_restores_and_resumes(worlds, tmp_path):
    """llama3.2-3b at tp 2: 4 steps uninterrupted (run A); 2 steps saved,
    then a fresh trainer restored from them runs 2 more (run B), bit for
    bit A's losses and every rank's leaves.  B's step-2 checkpoint restores
    on one device as the whole of the ranks' cuts, and into a world's ranks
    (``CheckpointParams``) as their cuts."""
    arch_id = "llama3.2-3b"
    arch, cfg = ARCHS[arch_id], ARCHS[arch_id].make_smoke()
    source = W.SeededParams.of(torch.Generator().manual_seed(11))
    ocfg = opt.AdamWConfig(**OPT)

    def trainer(name: str, ckpt_every: int):
        tcfg = TrainerConfig(total_steps=4, ckpt_every=ckpt_every, ckpt_dir=str(tmp_path / name))
        return W.TPTrainer(worlds(2), W.EngineSpec(arch_id, cfg, source, None, W.TrainSpec(
            tcfg, ocfg, _data(cfg))), owns_world=False)

    a = trainer("a", 4)
    hist_a = [m["loss"] for m in a.run(4)]
    leaves_a = a.on_every_rank(ranks.leaf_digests)
    a.close()

    b = trainer("b", 2)
    b.run(2)
    at_two = b.on_every_rank(ranks.leaf_digests)
    whole, _ = b.on_every_rank(ranks.whole_params)
    b.close()
    resumed = trainer("b", 2)
    assert resumed.try_restore() and resumed.step == 2
    assert resumed.on_every_rank(ranks.leaf_digests) == at_two
    hist_b = [m["loss"] for m in resumed.run(2)]
    assert hist_b == hist_a[2:]
    assert resumed.on_every_rank(ranks.leaf_digests) == leaves_a
    whole_4, _ = resumed.on_every_rank(ranks.whole_params)
    resumed.close()

    spec = cbase.model_spec(arch, cfg)
    one = Trainer(cbase.loss_fn(arch, cfg), nninit.materialize(spec, torch.Generator()),
                  TrainerConfig(ckpt_dir=str(tmp_path / "b")), ocfg, None, device="cpu")
    assert one.try_restore() and one.step == 4
    for got, want in zip(tree_leaves(one.params), tree_leaves(whole_4)):
        assert torch.equal(got, want)
    shapes = nninit.shapes(spec)
    template = {"opt": opt.state_shapes(shapes, ocfg), "params": shapes}
    served = W.TPModel(worlds(2), W.EngineSpec(arch_id, cfg, W.CheckpointParams(
        str(tmp_path / "b"), template, key="params", step=2), None), owns_world=False)
    assert served.on_every_rank(ranks.leaf_digests) == at_two
    served.close()
    assert [w.shape for w in tree_leaves(whole)] == [t.shape for t in tree_leaves(shapes)]


def test_quantized_moments_refused_over_a_world(worlds, tmp_path):
    """8-bit moments over a live world raise ``NotImplementedError`` naming
    ROADMAP Queue 1 #5, on every rank before any collective, so the world
    survives."""
    cfg = ARCHS["llama3.2-3b"].make_smoke()
    spec = W.EngineSpec("llama3.2-3b", cfg, W.SeededParams.of(torch.Generator().manual_seed(0)),
                        None, W.TrainSpec(TrainerConfig(ckpt_dir=str(tmp_path)),
                                          opt.AdamWConfig(quantized_state=True), _data(cfg)))
    with pytest.raises(NotImplementedError, match="Queue 1 #5"):
        W.TPTrainer(worlds(2), spec, owns_world=False)
    assert not worlds(2).closed
    with pytest.raises(NotImplementedError, match="#10"):
        W.tp_trainer("internvl2-26b", ARCHS["internvl2-26b"].make_smoke(), None, 2,
                     ("cpu", "cpu"), None, None, None)


def test_a_raise_after_a_backward_collective_breaks_the_world():
    cfg = ARCHS["llama3.2-3b"].make_smoke()
    model = W.tp_model("llama3.2-3b", cfg, W.SeededParams.of(torch.Generator().manual_seed(0)),
                       2, ("cpu", "cpu"), timeout_s=TIMEOUT_S)
    with pytest.raises(W.WorldError, match="after a collective"):
        model.on_every_rank(ranks.raise_after_a_backward_collective)
    assert model.world.closed
