"""Pipeline stages (`--pp`, lr2ppo_torch/parallel/pipeline.py) on the CPU,
against the JAX package's GPipe program (lr2ppo_tpu/parallel/pipeline.py)
and the port in one process:

  * pack/unpack of a reference-keyed state equal to JAX's of the same tree,
    and check_pp_supported refusing what JAX refuses, with its messages;
  * one micro-batch's loss and every gradient through the port's schedule at
    pp 2 and pp 4 (M = 4, ranks over gloo, tests/test_torch_parallel.py:
    spawn) against JAX's make_pp_loss_apply on its 8 host devices and
    against the port's plain tower, in float32 at dropout 0, to JAX's own
    tolerance (rtol 5e-4, atol 1e-5);
  * the pretraining CLI at pp 2, pp 4 with remat, pp 2 x tp 2 and pp 2 x
    dp 2, 4 steps of 2 accumulated micro-batches at dropout 0, against the
    CLI in one process (JAX's trainer tolerance, rtol 5e-3 atol 2e-4 after
    4 steps); a `.state` resume at pp 2 equal to the uninterrupted run bit
    for bit; the unpacked `-best` and final `.bin` loading strict into a
    plain TowerModel.

The tower is the JAX tests' `_cfg`: 4 layers of 16, 2 heads, vocabulary 32.
The ranks import no JAX."""

import json

import numpy as np
import pytest
import torch

from lr2ppo_torch.parallel import pipeline as tpipe
from lr2ppo_torch.towers import (TowerConfig, TowerModel,
                                 load_tower_checkpoint)
from lr2ppo_torch.towers.torch_import import tower_params_from_flax
from test_torch_parallel import spawn

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _restore_special_ids():
    """The CLI sets the port's processors' module-wide frame ids from the
    tokenizer (this file's vocabulary puts <pad> first): put them back when
    the module is done, so a later file in the same worker frames its
    instances with the defaults."""
    from lr2ppo_torch.data import pretrain_processors as tpp

    old = (tpp.CLS, tpp.PAD, tpp.SEP)
    yield
    tpp.set_special_ids(*old)

L, M = 4, 4
B, S, V = 8, 12, 32
RAW = dict(emb_size=16, hidden_size=16, feedforward_size=32, heads_num=2,
           layers_num=L, max_seq_length=S, dropout=0.0, vocab_size=V,
           embedding=["word", "pos"], encoder="transformer",
           mask="fully_visible", target=["mlm"])
# JAX's own pp tolerances: the gradient (tests/test_pipeline.py) and the
# trainer after 4 steps (test_pp_trainer_matches_plain_and_exports_unpacked)
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-5
FIT_RTOL, FIT_ATOL = 5e-3, 2e-4


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(5, V, (B, S)).astype(np.int32)
    tgt = np.where(src % 7 == 0, src, 0).astype(np.int32)
    seg = np.ones((B, S), np.int32)
    return src, tgt, seg


@pytest.fixture(scope="module")
def jax_tower():
    import jax
    from lr2ppo_tpu.towers.model import TowerConfig as JTowerConfig
    from lr2ppo_tpu.towers.model import TowerModel as JTowerModel

    src, tgt, seg = _batch()
    model = JTowerModel(JTowerConfig.from_dict(RAW))
    params = model.init(jax.random.PRNGKey(0), src, tgt, seg)
    return model, jax.tree.map(np.asarray, params)


def test_pack_and_unpack_equal_jax(jax_tower):
    import jax
    from lr2ppo_tpu.parallel import pipeline as jpipe

    _model, params = jax_tower
    state = tower_params_from_flax(params)
    for pp in (2, 4):
        packed = tpipe.pack_pipeline_params(state, L, pp)
        jpacked = jpipe.pack_pipeline_params(params, L, pp)
        # the stack carried across as one layer's tree: [s, j] of each
        # stacked leaf is layer s * L/pp + j
        for s in range(pp):
            for j in range(L // pp):
                layer = jax.tree.map(lambda a, s=s, j=j: a[s, j],
                                     jpacked["params"][jpipe.STACK_KEY])
                want = tower_params_from_flax(
                    {"params": {"encoder": {"transformer_0": layer}}})
                for k, w in want.items():
                    rest = k.split(".", 3)[3]
                    got = packed[f"{tpipe.STACK_KEY}.{rest}"][s, j]
                    assert torch.equal(got, w), (pp, s, j, k)
        assert not any(k.startswith("encoder.transformer.") for k in packed)
        back = tpipe.unpack_pipeline_params(packed, L, pp)
        assert back.keys() == state.keys()
        assert all(torch.equal(back[k], state[k]) for k in state)
        jback = tower_params_from_flax(
            jpipe.unpack_pipeline_params(jpacked, L, pp))
        assert all(torch.equal(jback[k], back[k]) for k in state)


@pytest.mark.parametrize("kw,mesh", [
    ({}, {}),
    ({"parameter_sharing": True}, {}),
    ({"layers_num": 6}, {}),
    ({}, {"zero1": True}),
    ({}, {"fsdp": True}),
    ({"seq_parallel": True}, {}),
    ({"has_residual_attention": True}, {}),
    ({"relative_position_embedding": True}, {}),
    ({"factorized_embedding_parameterization": True}, {}),
    ({"encoder": "lstm"}, {}),
], ids=["ok", "sharing", "layers", "zero1", "fsdp", "sp", "residual",
        "relative", "factorized", "lstm"])
def test_check_pp_supported_refuses_what_jax_refuses(kw, mesh):
    from lr2ppo_tpu.config import MeshConfig
    from lr2ppo_tpu.parallel import pipeline as jpipe
    from lr2ppo_tpu.towers.model import TowerConfig as JTowerConfig

    raw = {**RAW, **kw}
    mcfg = MeshConfig(pp=4, **mesh)

    def outcome(check, cfg):
        try:
            check(cfg, mcfg)
        except ValueError as e:
            return str(e)
        return None

    want = outcome(jpipe.check_pp_supported, JTowerConfig.from_dict(raw))
    got = outcome(tpipe.check_pp_supported, TowerConfig.from_dict(raw))
    assert got == want
    assert (want is None) == (kw == {} and mesh == {})


def test_keep_stage_holds_its_layers_only():
    cfg = TowerConfig.from_dict({**RAW, "layernorm_positioning": "pre"})
    full = TowerModel(cfg, with_target=True).state_dict().keys()
    seen = set()
    for s in range(2):
        keys = set(tpipe.keep_stage(TowerModel(cfg, with_target=True), 2,
                                    s).state_dict())
        assert keys == {k for k in full if tpipe.stage_owns(k, L, 2, s)}
        seen |= keys
    assert seen == set(full)
    assert any(k.startswith("embedding.") for k in
               tpipe.keep_stage(TowerModel(cfg, with_target=True), 2, 0)
               .state_dict())


# -- one micro-batch through the schedule --------------------------------
def _grads_rank(rank, world, url, state, batch, pp):
    from lr2ppo_torch.parallel import mesh as pm
    from lr2ppo_torch.parallel.pipeline import (GPipe, gather_to_first,
                                                keep_stage)
    from lr2ppo_torch.train.common import DeviceCtx

    from lr2ppo_torch.config import Config

    mesh = pm.make_mesh(1, 1, pp)
    pm.set_active(mesh)
    model = TowerModel(TowerConfig.from_dict(RAW), with_target=True)
    model.load_state_dict(state, strict=True)
    ctx = DeviceCtx("cpu", mesh=mesh)
    ctx.place(keep_stage(model, pp, mesh.pp_rank))
    pipe = GPipe(model, mesh, M, None, "cpu")
    loss, correct, denom = pipe.forward_backward(
        *(torch.from_numpy(a) for a in batch), base=0)
    grads = gather_to_first({k: p.grad for k, p in
                             model.named_parameters()}, mesh)
    # grad_clip's global norm sums the stages' squared sums over pp
    optim = Config().optim
    optim.grad_clip = 1.0
    norm = float(ctx.optimizer(optim, model, 10)._global_norm())
    return (float(loss), float(correct), float(denom),
            {k: v.numpy() for k, v in grads.items()}, pipe.p2p.bytes, norm)


@pytest.fixture(scope="module")
def jax_pp_grads(jax_tower):
    """JAX's pipelined loss and unpacked gradients at pp 2 and 4 (dp 2)."""
    import jax
    from lr2ppo_tpu.parallel import pipeline as jpipe
    from lr2ppo_tpu.towers.model import TowerConfig as JTowerConfig

    model, params = jax_tower
    cfg = JTowerConfig.from_dict(RAW)
    src, tgt, seg = _batch()
    out = {}
    for pp in (2, 4):
        mesh = jpipe.make_pp_mesh(dp=2, pp=pp)
        packed = jpipe.place_pipeline_params(
            jpipe.pack_pipeline_params(params, L, pp), mesh)
        loss_apply = jpipe.make_pp_loss_apply(model, cfg, mesh, pp, M)

        def loss_fn(p, loss_apply=loss_apply):
            out = loss_apply(p, src, tgt, seg, jax.random.PRNGKey(1),
                             deterministic=True)
            return out[0], out[1:]

        (loss, (c, d)), g = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(packed)
        g = jpipe.unpack_pipeline_params(
            jax.tree.map(np.asarray, jax.device_get(g)), L, pp)
        out[pp] = (float(loss), float(c), float(d),
                   tower_params_from_flax(g))
    return out


@pytest.mark.parametrize("pp", [2, 4])
def test_pp_loss_and_gradients_match_jax_and_world_1(tmp_path, jax_tower,
                                                     jax_pp_grads, pp):
    _model, params = jax_tower
    state = tower_params_from_flax(params)
    batch = _batch()
    ranks = spawn(_grads_rank, pp, tmp_path, state, batch, pp)
    loss, correct, denom, grads, p2p, norm = ranks[0]
    jloss, jc, jd, jgrads = jax_pp_grads[pp]
    # the port in one process
    model = TowerModel(TowerConfig.from_dict(RAW), with_target=True)
    model.load_state_dict(state, strict=True)
    ref = model(*(torch.from_numpy(a) for a in batch), deterministic=False,
                generator=torch.Generator())
    ref[0].backward()
    plain = {k: p.grad.numpy() for k, p in model.named_parameters()}
    np.testing.assert_allclose(loss, jloss, rtol=2e-5)
    np.testing.assert_allclose(loss, float(ref[0].detach()), rtol=2e-5)
    assert (correct, denom) == (jc, jd) == (float(ref[1]), float(ref[2]))
    assert grads.keys() == jgrads.keys() == plain.keys()
    for k, g in grads.items():
        np.testing.assert_allclose(g, jgrads[k].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
        np.testing.assert_allclose(g, plain[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
    # M activations forward and M gradients back over each of pp - 1 hops,
    # counted on rank 0 (stage 0: sends M, receives M)
    assert p2p == 2 * M * (B // M) * S * RAW["hidden_size"] * 4
    whole = float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                              for g in plain.values())))
    assert [r[5] for r in ranks] == pytest.approx([whole] * pp, rel=1e-5)


# -- the trainer through the CLI ------------------------------------------
TOKENS = ["<pad>", "<unk>", "<s>", "</s>", "<mask>"] + [
    f"w{i}" for i in range(V - 5)]
STEPS = 4


def _argv(tmp_path, **tower):
    (tmp_path / "v.txt").write_text("".join(t + "\n" for t in TOKENS))
    rng = np.random.RandomState(0)
    (tmp_path / "c.txt").write_text("".join(
        " ".join(rng.choice(TOKENS[5:], 10)) + "\n" for _ in range(60)))
    (tmp_path / "tower.json").write_text(json.dumps({**RAW, **tower}))
    return ["--corpus_path", str(tmp_path / "c.txt"), "--tower_config",
            str(tmp_path / "tower.json"), "--tokenizer", "space",
            "--vocab_path", str(tmp_path / "v.txt"), "--batch_size", "8",
            "--accumulation_steps", "2", "--seq_length", str(S),
            "--total_steps", str(STEPS), "--report_steps", "1",
            "--learning_rate", "1e-2"]


def _cli_rank(rank, world, url, argv):
    from lr2ppo_torch.cli import pretrain

    if world > 1:
        argv = argv + ["--distributed", "true", "--coordinator", url,
                       "--num_processes", str(world), "--process_id",
                       str(rank)]
    return pretrain.main(argv, device="cpu")


LEGS = {"one": (1, []), "pp2": (2, ["--pp", "2"]),
        "pp4_remat": (4, ["--pp", "4"]),
        "pp2_tp2": (4, ["--pp", "2", "--tp", "2"]),
        "pp2_dp2": (4, ["--pp", "2", "--dp", "2"])}


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    out = {}
    for name, (world, extra) in LEGS.items():
        d = tmp_path_factory.mktemp(name)
        tower = {"remat": True} if name.endswith("remat") else {}
        argv = _argv(d, **tower) + extra + [
            "--output_model_path", str(d / "m"), "--log_path",
            str(d / "m.log"), "--save_checkpoint_steps", "2"]
        spawn(_cli_rank, world, d, argv, join=world > 1, timeout=150)
        out[name] = (d, argv)
    return out


@pytest.mark.parametrize("leg", ["pp2", "pp4_remat", "pp2_tp2", "pp2_dp2"])
def test_pp_cli_tracks_world_1(fits, leg):
    ref_dir, _ = fits["one"]
    d, _ = fits[leg]
    ref, got = _records(ref_dir / "m.log.jsonl"), _records(d / "m.log.jsonl")
    assert [r["step"] for r in got] == list(range(1, STEPS + 1))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=FIT_RTOL,
                                   atol=FIT_ATOL)
        assert a["acc"] == pytest.approx(b["acc"], abs=1e-6)
    want, have = (load_tower_checkpoint(str(ref_dir / "m")),
                  load_tower_checkpoint(str(d / "m")))
    assert have.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(have[k].numpy(), want[k].numpy(),
                                   rtol=FIT_RTOL, atol=FIT_ATOL, err_msg=k)


@pytest.mark.parametrize("ckpt", ["m", "m-best"])
def test_pp_checkpoints_are_unpacked_and_load_strict(fits, ckpt):
    d, _ = fits["pp4_remat"]
    model = TowerModel(TowerConfig.from_dict(RAW), with_target=True)
    model.load_state_dict(load_tower_checkpoint(str(d / ckpt)), strict=True)
    # rank 0 wrote them; the other stages' ranks wrote nothing
    assert sorted(p.name for p in d.iterdir() if p.name.startswith("m")) == [
        "m", "m-2", "m-4", "m-best", "m.log", "m.log.jsonl"]


def test_pp_resume_at_the_same_pp_is_the_uninterrupted_run(fits, tmp_path):
    d, argv = fits["pp2"]
    out = tmp_path / "resumed"
    argv = [a for a in argv]
    argv[argv.index("--output_model_path") + 1] = str(out)
    argv[argv.index("--log_path") + 1] = str(out) + ".log"
    spawn(_cli_rank, 2, tmp_path, argv + ["--resume_path", str(d / "m-2")],
          timeout=150)
    assert [r["step"] for r in _records(str(out) + ".log.jsonl")] == [3, 4]
    want = load_tower_checkpoint(str(d / "m"))
    got = load_tower_checkpoint(str(out))
    assert all(torch.equal(got[k], want[k]) for k in want)
    from lr2ppo_torch.train.checkpoints import load_state

    payload = load_state(str(d / "m-2"))
    # the .state holds the whole model and optimizer under reference keys
    assert payload["models"]["model"].keys() == want.keys()
    assert payload["optims"]["model"]["mu"].keys() == want.keys()


def test_pp_flags_keep_the_jax_checks(tmp_path):
    from lr2ppo_torch.cli import pretrain

    argv = _argv(tmp_path) + ["--output_model_path", str(tmp_path / "m")]
    (tmp_path / "odd").mkdir()
    with pytest.raises(ValueError, match="layers_num"):
        pretrain.main(_argv(tmp_path / "odd", layers_num=3) + ["--pp", "2"],
                      device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        pretrain.main(argv + ["--pp", "2"], device="cpu")
