"""The encoder-only text pretraining processors of the port
(lr2ppo_torch/data/pretrain_processors.py) and their batch forms
(train/pretrain.py:form_args) against the JAX package's:

* the five datasets (bert, albert, cls_mlm, bilm, prefixlm) built from the
  same corpus, tokenizer and seed give the same items, array for array, in
  two epochs of dynamic masking, at the XLM-R frame layout and at another;
* set_special_ids and read_documents;
* the pair_sp, pair_cls and bilm forms: the loss and every gradient of a
  tiny tower (hidden 32, one layer, dropout 0) against the loss function of
  JAX's make_pretrain_step_form (its form_args and _norm_target_out), at
  rtol 5e-4 / atol 1e-5 of each tensor's scale, and the bilm form on its
  own bilstm tower;
* the pretraining CLI at bert (mlm + sp) for 2 steps against the JAX CLI.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lr2ppo_tpu.data import pretrain_processors as jpp
from lr2ppo_tpu.data.tokenizers import SpaceTokenizer as JSpace
from lr2ppo_tpu.towers.model import TowerConfig as JTowerConfig
from lr2ppo_tpu.towers.model import TowerModel as JTowerModel
from lr2ppo_tpu.train import pretrain as jtrain
from lr2ppo_torch.data import pretrain_processors as tpp
from lr2ppo_torch.data.tokenizers import SpaceTokenizer
from lr2ppo_torch.towers import TowerConfig, TowerModel
from lr2ppo_torch.towers.torch_import import tower_params_from_flax
from lr2ppo_torch.train import pretrain as ttrain

torch.set_num_threads(1)

TOKENS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"] + list("abcdefgh")
MASK, VOCAB, SEQ = 4, 13, 24
RTOL, ATOL = 5e-4, 1e-5


@pytest.fixture(autouse=True)
def _restore_special_ids():
    """Both packages' frame ids are module-wide: put them back after each
    test for the next one in the worker."""
    old = [(m, (m.CLS, m.PAD, m.SEP)) for m in (jpp, tpp)]
    yield
    for m, ids in old:
        m.set_special_ids(*ids)


@pytest.fixture
def files(tmp_path):
    (tmp_path / "v.txt").write_text("".join(t + "\n" for t in TOKENS))
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(8):
        for _ in range(5):
            lines.append(" ".join(rng.choice(list("abcdefgh"),
                                             int(rng.integers(3, 8)))))
        lines.append("")
    (tmp_path / "docs.txt").write_text("\n".join(lines) + "\n")
    rows = []
    for i in range(12):
        a = " ".join(rng.choice(list("abcdefgh"), int(rng.integers(2, 6))))
        b = " ".join(rng.choice(list("abcdefgh"), int(rng.integers(2, 9))))
        rows.append(f"{i % 3}\t{a}\t{b}" if i % 2 else f"{i % 3}\t{a}")
    (tmp_path / "cls.tsv").write_text("\n".join(rows) + "\n")
    (tmp_path / "prefix.tsv").write_text("".join(
        "\t".join(r.split("\t")[1:3]) + "\n" for r in rows if r.count("\t")
        == 2))
    return {k: str(tmp_path / f) for k, f in
            (("vocab", "v.txt"), ("docs", "docs.txt"), ("cls", "cls.tsv"),
             ("prefix", "prefix.tsv"))}


def _build(mod, tok, name, files, seed=7):
    return {
        "bert": lambda: mod.BertDocsDataset(
            files["docs"], tok, SEQ, VOCAB, MASK, seed=seed,
            short_seq_prob=0.3, dup_factor=2),
        "albert": lambda: mod.AlbertDocsDataset(
            files["docs"], tok, SEQ, VOCAB, MASK, seed=seed,
            short_seq_prob=0.3),
        "cls_mlm": lambda: mod.ClsMlmTsvDataset(files["cls"], tok, SEQ,
                                                VOCAB, MASK, seed=seed),
        "bilm": lambda: mod.BilmCorpusDataset(files["docs"], tok, 4),
        "prefixlm": lambda: mod.PrefixlmTsvDataset(files["prefix"], tok,
                                                   12),
    }[name]()


PROCESSORS = ["bert", "albert", "cls_mlm", "bilm", "prefixlm"]


@pytest.mark.parametrize("layout", ["xlmr", "bert"])
@pytest.mark.parametrize("name", PROCESSORS)
def test_datasets_give_jaxs_items(files, name, layout):
    """Same corpus, tokenizer ids and seed: the same number of items and
    every array of every item equal, in epochs 0 and 1 (the mlm masks
    reseed per epoch and item); each layout's frame ids are set in both
    packages, whatever an earlier test left."""
    for m in (jpp, tpp):
        m.set_special_ids(*((2, 1, 3) if layout == "bert" else (0, 1, 2)))
    jds = _build(jpp, JSpace(files["vocab"]), name, files)
    tds = _build(tpp, SpaceTokenizer(files["vocab"]), name, files)
    assert len(tds) == len(jds) > 0
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(jds)):
            want, got = jds.get(i), tds.get(i)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{name} {i} {k}")
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype


def test_set_special_ids_and_read_documents(files):
    for m in (jpp, tpp):
        m.set_special_ids(101, 0, 102)
    assert (tpp.CLS, tpp.PAD, tpp.SEP) == (jpp.CLS, jpp.PAD, jpp.SEP) == (
        101, 0, 102)
    assert tpp._pad_pair_instance([5, 6], [7], 1, 8)[0].tolist() == \
        jpp._pad_pair_instance([5, 6], [7], 1, 8)[0].tolist()
    assert tpp.read_documents(files["docs"], SpaceTokenizer(files["vocab"])) \
        == jpp.read_documents(files["docs"], JSpace(files["vocab"]))


# -- the batch forms against JAX's step loss --------------------------------
RAW = dict(emb_size=32, hidden_size=32, feedforward_size=64, heads_num=4,
           layers_num=1, dropout=0.0, max_seq_length=SEQ, vocab_size=VOCAB,
           embedding=["word", "pos", "seg"], encoder="transformer",
           mask="fully_visible", labels_num=3)
FORMS = {"pair_sp": ("bert", ["mlm", "sp"]),
         "pair_cls": ("cls_mlm", ["mlm", "cls"]),
         "bilm": ("bilm", ["bilm"])}


def _batch(ds, n=6):
    items = [ds.get(i) for i in range(n)]
    return {k: np.stack([np.asarray(it[k]) for it in items])
            for k in items[0]}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_forms_loss_and_every_gradient_match_jax(files, form):
    proc, targets = FORMS[form]
    raw = {**RAW, "target": targets}
    if form == "bilm":
        raw["max_seq_length"] = 4
    mb = _batch(_build(tpp, SpaceTokenizer(files["vocab"]), proc, files))
    jmodel = JTowerModel(JTowerConfig.from_dict(raw))
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), *jtrain.form_args(form, mb)))
    rows = mb["src"].shape[0]

    def loss_fn(p):
        out = jmodel.apply({"params": p}, *jtrain.form_args(form, mb),
                           deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})
        return jtrain._norm_target_out(out, rows)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, params["params"]))
    want = tower_params_from_flax(jax.tree.map(np.asarray, jgrads))
    model = TowerModel(TowerConfig.from_dict(raw), with_target=True)
    model.load_state_dict(tower_params_from_flax(params), strict=True)
    tmb = {k: torch.from_numpy(v) for k, v in mb.items()}
    out = model(*ttrain.form_args(form, tmb), deterministic=False,
                generator=torch.Generator().manual_seed(0))
    loss = ttrain.norm_target_out(out, rows)[0]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=RTOL)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    top = max(float(w.abs().max()) for w in want.values())
    for k, g in got.items():
        w = want[k].numpy()
        # the key bias's gradient is 0 but for rounding: scales floor at 1%
        # of the model's largest gradient
        scale = max(float(np.abs(w).max()), 1e-2 * top)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * scale, err_msg=k)


def test_a_bilstm_bilm_tower_raises_at_the_encoder(files):
    """The bilm processor's own tower (ELMo-style: two bilstm stacks, the
    forward and backward heads) now trains: its loss and every gradient in
    the bilm form against JAX's step loss, as the transformer forms above
    (tests/test_torch_encoders.py holds its encoder and one step)."""
    raw = {**RAW, "encoder": "bilstm", "target": ["bilm"],
           "max_seq_length": 4, "embedding": ["word"]}
    mb = _batch(_build(tpp, SpaceTokenizer(files["vocab"]), "bilm", files))
    jmodel = JTowerModel(JTowerConfig.from_dict(raw))
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), *jtrain.form_args("bilm", mb)))

    def loss_fn(p):
        out = jmodel.apply({"params": p}, *jtrain.form_args("bilm", mb))
        return jtrain._norm_target_out(out, mb["src"].shape[0])[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, params["params"]))
    model = TowerModel(TowerConfig.from_dict(raw), with_target=True)
    model.load_state_dict(tower_params_from_flax(params), strict=True)
    out = model(*ttrain.form_args("bilm", {k: torch.from_numpy(v)
                                           for k, v in mb.items()}),
                deterministic=False, generator=torch.Generator())
    loss = ttrain.norm_target_out(out, mb["src"].shape[0])[0]
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=RTOL)
    want = tower_params_from_flax(jax.tree.map(np.asarray, jgrads))
    assert {k for k, _ in model.named_parameters()} == want.keys()
    for k, p in model.named_parameters():
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=RTOL,
                                   atol=ATOL * float(np.abs(w).max()),
                                   err_msg=k)


def test_unknown_form_raises():
    """Every JAX batch form is ported (the vilt and beit forms map their
    keys as JAX's form_args does); an unknown one raises naming it."""
    mb = {k: np.full((2, 3), i) for i, k in enumerate(
        ("src_text", "src_image", "tgt_mlm", "tgt_match", "seg", "mask",
         "tgt"))}
    for form in ("vilt", "beit"):
        got, want = ttrain.form_args(form, mb), jtrain.form_args(form, mb)
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        assert all(a is b for a, b in zip(jax.tree_util.tree_leaves(got),
                                          jax.tree_util.tree_leaves(want)))
    with pytest.raises(KeyError, match="bogus"):
        ttrain.form_args("bogus", {})


# -- the CLI ----------------------------------------------------------------
def test_cli_at_bert_matches_the_jax_cli(files, tmp_path):
    """bert (the mlm and sp targets, pair_sp) for 2 steps of 2 accumulated
    micro-batches through both CLIs on the same corpus and starting
    weights: the same per-step losses and accuracies to 1e-4."""
    from lr2ppo_tpu.cli import pretrain as jcli
    from lr2ppo_torch.cli import pretrain as tcli
    from lr2ppo_torch.towers.model import init_weights
    from lr2ppo_torch.train.checkpoints import save_model

    raw = {**RAW, "target": ["mlm", "sp"]}
    (tmp_path / "tower.json").write_text(json.dumps(raw))
    model = TowerModel(TowerConfig.from_dict(raw), with_target=True)
    init_weights(model, torch.Generator().manual_seed(3))
    init = str(tmp_path / "init.bin")
    save_model(init, model)
    recs = {}
    for name, main, kw in (("jax", jcli.main, {}),
                           ("torch", tcli.main, {"device": "cpu"})):
        out = str(tmp_path / name)
        main(["--corpus_path", files["docs"], "--tower_config",
              str(tmp_path / "tower.json"), "--data_processor", "bert",
              "--tokenizer", "space", "--vocab_path", files["vocab"],
              "--pretrained_model_path", init, "--output_model_path", out,
              "--batch_size", "4", "--accumulation_steps", "2",
              "--seq_length", str(SEQ), "--total_steps", "2",
              "--report_steps", "1", "--learning_rate", "1e-3",
              "--log_path", out + ".log", "--dp", "1"], **kw)
        with open(out + ".log.jsonl") as f:
            recs[name] = [json.loads(x) for x in f]
    assert len(recs["torch"]) == len(recs["jax"]) == 2
    for t, j in zip(recs["torch"], recs["jax"]):
        assert np.isfinite(t["loss"])
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-4)
        np.testing.assert_allclose(t["acc"], j["acc"], atol=1e-4)


def test_pp_takes_the_simple_form_only(files, tmp_path):
    """JAX's rule: under --pp only the 'simple' batch form runs, so bert
    (pair_sp) refuses --pp 2 before the corpus is read."""
    from lr2ppo_torch.cli import pretrain as tcli

    (tmp_path / "tower.json").write_text(json.dumps(
        {**RAW, "layers_num": 2, "target": ["mlm", "sp"]}))
    with pytest.raises(ValueError, match="'simple' batch form"):
        tcli.main(["--corpus_path", files["docs"], "--tower_config",
                   str(tmp_path / "tower.json"), "--data_processor", "bert",
                   "--tokenizer", "space", "--vocab_path", files["vocab"],
                   "--pp", "2", "--output_model_path",
                   str(tmp_path / "x")], device="cpu")
