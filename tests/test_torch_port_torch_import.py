"""Reference checkpoint import and export: the port's
``data/torch_import.py`` and its two tools against the JAX package's on
the CPU.  The cases of ``tests/test_torch_import.py``, each placed leaf
bit-equal to JAX's ``import_mpqe_params`` and the same ``ImportReport``
lists; then both directions across packages (JAX's exported file into
the port, the port's export into JAX's importer) and the import tool's
run dir served by the port against the JAX ``QueryServer`` on JAX's
import of the same file.  Leaves the classifier does not place keep each
package's own initialisation (``allow_partial``), so only placed leaves
are compared."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import train as jtrain_cli
from mpqe_tpu.data import loader as jload
from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu.data import torch_import as jti
from mpqe_tpu.models import mpqe as jm
from mpqe_tpu.serve import QueryServer as JaxServer
from mpqe_tpu.train import checkpoint as jckpt
from mpqe_tpu.train import loop as jloop
from mpqe_tpu.train.metrics import MetricsWriter as JMetrics
from mpqe_tpu_torch import convert
from mpqe_tpu_torch import evaluate as tev
from mpqe_tpu_torch import serve as tserve
from mpqe_tpu_torch.data import torch_import as tti
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.tools import export_torch_checkpoint as texport
from mpqe_tpu_torch.tools import import_torch_checkpoint as timport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, L, NB = 16, 2, 4
N_ENT, N_MODES = 50, 3
MODES = ("alpha", "beta", "gamma")
SYN = ["--data", "synthetic", "--seed", "0", "--syn_entities", "200",
       "--syn_modes", "3", "--syn_rels", "6", "--syn_triples", "600",
       "--syn_train_queries", "100", "--syn_val_queries", "20"]


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _layer_keys(i, n_rels, num_bases):
    g = torch.Generator().manual_seed(100 + i)
    keys = {f"rgcn.convs.{i}.root": torch.randn(D, D, generator=g),
            f"rgcn.convs.{i}.bias": torch.randn(D, generator=g)}
    if num_bases:
        keys[f"rgcn.convs.{i}.weight"] = torch.randn(num_bases, D, D,
                                                     generator=g)
        keys[f"rgcn.convs.{i}.comp"] = torch.randn(n_rels, num_bases,
                                                   generator=g)
    else:
        keys[f"rgcn.convs.{i}.weight"] = torch.randn(n_rels, D, D,
                                                     generator=g)
    return keys


def _basis_sd(n_rels=8, num_bases=NB):
    g = torch.Generator().manual_seed(0)
    sd = {"enc.ent.weight": torch.randn(N_ENT, D, generator=g),
          "mode_embeddings.weight": torch.randn(N_MODES, D, generator=g)}
    for i in range(L):
        sd.update(_layer_keys(i, n_rels, num_bases))
    return sd


def _kw(n_rels=8, num_bases=NB, readout="tgt", n_entities=N_ENT):
    return dict(n_entities=n_entities, n_modes=N_MODES, n_rels=n_rels,
                embed_dim=D, n_layers=L, num_bases=num_bases,
                readout=readout)


def _jleaf(params, path):
    node = params
    for p in path.split("."):
        node = node[int(p)] if isinstance(node, list) else node[p]
    return np.asarray(node)


def _both(sd, kw, **opts):
    """JAX's and the port's import of the same numpy state dict: the
    reports equal, every placed leaf bit-equal; returns (JAX params, port
    model, report)."""
    np_sd = {k: v.numpy() for k, v in sd.items()}
    opts.setdefault("mode_names", MODES)
    jparams, jrep = jti.import_mpqe_params(
        np_sd, jm.MPQEConfig(**kw), jax.random.PRNGKey(0), **opts)
    model, trep = tti.import_mpqe_params(
        np_sd, tm.MPQEConfig(**kw), torch.Generator().manual_seed(0),
        **opts)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    tparams = dict(model.named_parameters())
    for path in trep.mapped:
        np.testing.assert_array_equal(tparams[path].detach().numpy(),
                                      _jleaf(jparams, path), err_msg=path)
    return jparams, model, trep


def _raise_both(sd, kw, match, **opts):
    np_sd = {k: v.numpy() for k, v in sd.items()}
    opts.setdefault("mode_names", MODES)
    with pytest.raises(ValueError, match=match):
        jti.import_mpqe_params(np_sd, jm.MPQEConfig(**kw),
                               jax.random.PRNGKey(0), **opts)
    with pytest.raises(ValueError, match=match):
        tti.import_mpqe_params(np_sd, tm.MPQEConfig(**kw),
                               torch.Generator().manual_seed(0), **opts)


@pytest.mark.parametrize("num_bases", [NB, None])
def test_infer_shape_equals_jax(num_bases):
    np_sd = {k: v.numpy() for k, v in _basis_sd(num_bases=num_bases).items()}
    assert dataclasses.asdict(tti.infer_model_shape(np_sd)) == \
        dataclasses.asdict(jti.infer_model_shape(np_sd)) == dict(
            embed_dim=D, n_layers=L, n_rels=8, num_bases=num_bases)


@pytest.mark.parametrize("num_bases", [NB, None])
def test_whole_table_state_dict_placements(num_bases):
    sd = _basis_sd(num_bases=num_bases)
    _, model, rep = _both(sd, _kw(num_bases=num_bases))
    assert not rep.missing and not rep.unused_keys
    leaf = "basis" if num_bases else "w_rel"
    np.testing.assert_array_equal(
        getattr(model.layers[1], leaf).detach().numpy(),
        sd["rgcn.convs.1.weight"].numpy())


def _per_mode_sd(node_maps_list):
    sd = {}
    for i in range(L):
        sd.update(_layer_keys(i, 8, NB))
    g = torch.Generator().manual_seed(7)
    for m in MODES:
        sd[f"enc.features.{m}.weight"] = torch.randn(
            len(node_maps_list[m]), D, generator=g)
        sd[f"enc.vars.{m}.weight"] = torch.randn(1, D, generator=g)
    return sd


@pytest.mark.parametrize("as_dict", [False, True])
def test_per_mode_entity_tables_and_var_rows(as_dict):
    rng = np.random.default_rng(0)
    ids = np.arange(N_ENT)
    rng.shuffle(ids)
    nml = {"alpha": ids[:20].tolist(), "beta": ids[20:35].tolist(),
           "gamma": ids[35:].tolist()}
    sd = _per_mode_sd(nml)
    node_maps = ({m: {int(gid): j for j, gid in enumerate(v)}
                  for m, v in nml.items()} if as_dict else nml)
    _, model, rep = _both(sd, _kw(), node_maps=node_maps)
    assert not rep.missing
    ent = model.emb.ent.detach().numpy()
    for mi, m in enumerate(MODES):
        np.testing.assert_array_equal(ent[np.asarray(nml[m])],
                                      sd[f"enc.features.{m}.weight"].numpy())
        np.testing.assert_array_equal(model.emb.var[mi].detach().numpy(),
                                      sd[f"enc.vars.{m}.weight"].numpy()[0])


def test_missing_params_raise_and_allow_partial_keeps_the_port_init():
    sd = _basis_sd()
    del sd["enc.ent.weight"]
    _raise_both(sd, _kw(), "emb.ent")
    _, model, rep = _both(sd, _kw(), allow_partial=True)
    assert rep.missing == ["emb.ent"]
    init = tm.init_mpqe(torch.Generator().manual_seed(0), tm.MPQEConfig(**_kw()))
    assert torch.equal(model.emb.ent, init.emb.ent)


def test_init_is_drawn_only_for_what_is_unplaced():
    """A state dict that places every leaf draws no random init (the
    generator is left as it was); per-mode tables that leave global rows
    unclaimed keep those rows of ``init_mpqe``."""
    gen = torch.Generator().manual_seed(4)
    before = gen.get_state()
    tti.import_mpqe_params({k: v.numpy() for k, v in _basis_sd().items()},
                           tm.MPQEConfig(**_kw()), gen, mode_names=MODES)
    assert torch.equal(gen.get_state(), before)
    nml = {"alpha": list(range(20)), "beta": list(range(20, 35)),
           "gamma": list(range(35, 45))}  # rows 45.. are no mode's
    sd = {k: v.numpy() for k, v in _per_mode_sd(nml).items()}
    model, rep = tti.import_mpqe_params(
        sd, tm.MPQEConfig(**_kw()), torch.Generator().manual_seed(4),
        mode_names=MODES, node_maps=nml)
    assert not rep.missing
    init = tm.init_mpqe(torch.Generator().manual_seed(4),
                        tm.MPQEConfig(**_kw()))
    assert torch.equal(model.emb.ent[45:], init.emb.ent[45:])
    np.testing.assert_array_equal(model.emb.ent[35:45].detach().numpy(),
                                  sd["enc.features.gamma.weight"])


def test_per_mode_tables_require_node_maps():
    sd = _basis_sd()
    del sd["enc.ent.weight"]
    sd["enc.features.alpha.weight"] = torch.randn(20, D)
    sd["enc.features.beta.weight"] = torch.randn(15, D)
    sd["enc.features.gamma.weight"] = torch.randn(15, D)
    _raise_both(sd, _kw(), "node_maps")


def test_key_map_transpose_and_rel_perm():
    sd = _basis_sd()
    lin = torch.randn(D, D)
    sd["readout.pre.weight"] = lin
    key_map = {"readout.w_pre": {"key": "readout.pre.weight",
                                 "transpose": True}}
    _, model, rep = _both(sd, _kw(readout="mlp"), key_map=key_map,
                          allow_partial=True)
    np.testing.assert_array_equal(model.readout.w_pre.detach().numpy(),
                                  lin.numpy().T)
    assert "readout.w_post" in rep.missing
    perm = np.asarray([3, 2, 1, 0, 7, 6, 5, 4])
    _, model, _ = _both(_basis_sd(), _kw(), rel_perm=perm)
    np.testing.assert_array_equal(
        model.layers[0].coeff.detach().numpy(),
        _basis_sd()["rgcn.convs.0.comp"].numpy()[perm])
    # a key map entry with a row offset (a padding row)
    sd = _basis_sd()
    sd["padded"] = torch.cat([torch.zeros(1, D), sd.pop("enc.ent.weight")])
    _both(sd, _kw(), key_map={"emb.ent": {"key": "padded",
                                          "row_offset": 1}})


@pytest.mark.parametrize("num_bases", [NB, None])
def test_export_import_round_trip_and_across_packages(num_bases):
    """The port's export -> its import is the identity; JAX's importer
    reads the port's export bit for bit, and the port's importer JAX's
    export."""
    kw = _kw(num_bases=num_bases)
    model = tm.init_mpqe(torch.Generator().manual_seed(3),
                         tm.MPQEConfig(**kw))
    sd = tti.export_mpqe_state_dict(model)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    back, rep = tti.import_mpqe_params(
        np_sd, tm.MPQEConfig(**kw), torch.Generator().manual_seed(99),
        mode_names=MODES)
    assert not rep.missing and not rep.unused_keys
    jparams, jrep = jti.import_mpqe_params(
        np_sd, jm.MPQEConfig(**kw), jax.random.PRNGKey(99),
        mode_names=MODES)
    assert not jrep.missing and not jrep.unused_keys
    for name, p in model.named_parameters():
        assert torch.equal(dict(back.named_parameters())[name], p), name
        np.testing.assert_array_equal(_jleaf(jparams, name),
                                      p.detach().numpy(), err_msg=name)
    # the other way: JAX's export into the port
    jp = jm.init_mpqe(jax.random.PRNGKey(5), jm.MPQEConfig(**kw))
    model, rep = tti.import_mpqe_params(
        jti.export_mpqe_state_dict(jp), tm.MPQEConfig(**kw),
        torch.Generator(), mode_names=MODES)
    assert not rep.missing and not rep.unused_keys
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), _jleaf(jp, name))


def test_model_from_state_dict_reads_the_upstream_names():
    """``convert.model_from_state_dict`` runs the same classifier: a
    state dict under other PyG-style names loads, bit for bit."""
    sd = _basis_sd()
    sd["ent_embeddings.weight"] = sd.pop("enc.ent.weight")
    sd["model.layers.0.root"] = sd.pop("rgcn.convs.0.root")
    model = convert.model_from_state_dict(sd, tm.MPQEConfig(**_kw()))
    np.testing.assert_array_equal(model.emb.ent.detach().numpy(),
                                  sd["ent_embeddings.weight"].numpy())
    np.testing.assert_array_equal(model.layers[0].w_self.detach().numpy(),
                                  sd["model.layers.0.root"].numpy())


def test_load_state_dict_wrappers_and_bf16(tmp_path):
    sd = _basis_sd()
    for wrap in (None, "state_dict", "model_state_dict", "model"):
        path = str(tmp_path / f"{wrap}.pt")
        torch.save(sd if wrap is None else {wrap: sd, "epoch": 3}, path)
        got = tti.load_state_dict(path)
        assert sorted(got) == sorted(jti.load_state_dict(path))
        for k, v in got.items():
            np.testing.assert_array_equal(v, sd[k].numpy())
    path = str(tmp_path / "bf16.pt")
    torch.save({k: v.bfloat16() for k, v in sd.items()}, path)
    got = tti.load_state_dict(path)
    assert got["enc.ent.weight"].dtype == np.float32
    np.testing.assert_array_equal(got["enc.ent.weight"],
                                  sd["enc.ent.weight"].bfloat16().float())
    torch.save([1, 2], str(tmp_path / "list.pt"))
    with pytest.raises(ValueError, match="expected a state_dict"):
        tti.load_state_dict(str(tmp_path / "list.pt"))


def test_dict_node_maps_must_be_dense_permutation():
    sd = {}
    for i in range(L):
        sd.update(_layer_keys(i, 8, NB))
    sd["enc.features.alpha.weight"] = torch.randn(3, D)
    sd["enc.features.beta.weight"] = torch.randn(2, D)
    sd["enc.features.gamma.weight"] = torch.randn(2, D)
    for m in MODES:
        sd[f"enc.vars.{m}.weight"] = torch.randn(1, D)
    bad = {"alpha": {10: 0, 11: 2, 12: 3}, "beta": {0: 0, 1: 1},
           "gamma": {2: 0, 3: 1}}
    _raise_both(sd, _kw(), "dense 0..n-1", node_maps=bad)
    dup = {"alpha": [0, 1, 2], "beta": [2, 4], "gamma": [5, 6]}
    _raise_both(sd, _kw(), "claimed", node_maps=dup)


def test_mode_named_table_not_misclassified_as_var():
    sd = {}
    for i in range(L):
        sd.update(_layer_keys(i, 8, NB))
    sd["enc.features.alpha.weight"] = torch.randn(N_MODES, D)
    sd["enc.features.beta.weight"] = torch.randn(2, D)
    sd["enc.features.gamma.weight"] = torch.randn(2, D)
    for m in MODES:
        sd[f"enc.vars.{m}.weight"] = torch.randn(1, D)
    node_maps = {"alpha": [0, 1, 2], "beta": [3, 4], "gamma": [5, 6]}
    _, model, rep = _both(sd, _kw(n_entities=7), node_maps=node_maps)
    assert not rep.missing
    np.testing.assert_array_equal(model.emb.ent[:3].detach().numpy(),
                                  sd["enc.features.alpha.weight"].numpy())


def _quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        main(argv)
    return out.getvalue().strip().splitlines()


def test_export_cli_round_trip(tmp_path):
    """A port run dir -> .pt (the reference's keys) -> the JAX importer,
    bit for bit; the JAX export tool's file -> the port's importer."""
    kw = _kw()
    run = str(tmp_path / "run")
    model = tm.init_mpqe(torch.Generator().manual_seed(5),
                         tm.MPQEConfig(**kw))
    from mpqe_tpu_torch.train import checkpoint as tckpt
    from mpqe_tpu_torch.train import loop as tloop
    from mpqe_tpu_torch.train.metrics import MetricsWriter

    m = MetricsWriter(run)
    m.write_config(dataclasses.asdict(tm.MPQEConfig(**kw)),
                   "model_config.json")
    m.close()
    tckpt.save_checkpoint(os.path.join(run, "ckpt"), tloop.TrainState(
        model=model, optimizer=tloop.make_optimizer(
            tloop.TrainConfig(), model.parameters()), step=4))
    out = str(tmp_path / "model.pt")
    line = json.loads(_quiet(texport.main, ["--run_dir", run, "--out", out,
                                            "--device", "cpu"])[-1])
    assert line == {"out": out, "keys": 2 + 4 * L, "step": 4}
    sd = torch.load(out, weights_only=True)
    assert "enc.ent.weight" in sd and "rgcn.convs.1.comp" in sd
    jparams, _ = jti.import_mpqe_params(
        jti.load_state_dict(out), jm.MPQEConfig(**kw),
        jax.random.PRNGKey(0), mode_names=MODES)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(_jleaf(jparams, name),
                                      p.detach().numpy())
    # the JAX package's export tool, its file into the port
    jrun = str(tmp_path / "jrun")
    jm_ = JMetrics(jrun)
    jm_.write_config(dataclasses.asdict(jm.MPQEConfig(**kw)),
                     "model_config.json")
    jm_.close()
    state = jloop.init_train_state(jax.random.PRNGKey(5),
                                   jm.MPQEConfig(**kw), jloop.TrainConfig())
    jckpt.save_checkpoint(os.path.join(jrun, "ckpt"), state)
    jout = str(tmp_path / "jax_model.pt")
    _quiet(_tool("export_torch_checkpoint").main,
           ["--run_dir", jrun, "--out", jout])
    back, rep = tti.import_mpqe_params(
        tti.load_state_dict(jout), tm.MPQEConfig(**kw), torch.Generator(),
        mode_names=MODES)
    assert not rep.missing and not rep.unused_keys
    for name, p in back.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      _jleaf(state.params, name))


def test_cli_end_to_end_and_shape_overrides(tmp_path):
    """state_dict file -> the import tool's run dir -> its checkpoint
    holds the file's tensors and the port's evaluate CLI reads it; a
    --map-only checkpoint imports with explicit shape flags."""
    kg, _, _ = jtrain_cli.load_data(jtrain_cli.parse_args(SYN))
    g = torch.Generator().manual_seed(1)
    sd = {"enc.ent.weight": torch.randn(kg.n_entities, D, generator=g),
          "mode_embeddings.weight": torch.randn(kg.n_modes, D, generator=g)}
    for i in range(L):
        sd.update(_layer_keys(i, kg.n_rels, NB))
    ckpt = str(tmp_path / "reference_model.pt")
    torch.save(sd, ckpt)
    out = str(tmp_path / "imported")
    line = json.loads(_quiet(timport.main, [
        "--ckpt", ckpt, "--out", out, "--device", "cpu"] + SYN)[-1])
    assert line == {"run_dir": out, "mapped": 2 + 4 * L, "missing": [],
                    "unused_keys": []}
    run_cfg, mc = tev.read_run_dir(out)
    assert mc["num_bases"] == NB and mc["embed_dim"] == D
    assert run_cfg["imported_from"] == os.path.abspath(ckpt)
    _, step, model = tev.restore_model(out, tserve.config_from_json(mc),
                                       None, "cpu")
    assert step == 0
    np.testing.assert_array_equal(model.emb.ent.detach().numpy(),
                                  sd["enc.ent.weight"].numpy())
    lines = _quiet(tev.main, ["--run_dir", out, "--device", "cpu"])
    assert json.loads(lines[0])["step"] == 0

    odd = {"entity_table": sd["enc.ent.weight"],
           "var_table": sd["mode_embeddings.weight"],
           "oddly.named.self0": torch.randn(D, D, generator=g),
           "oddly.named.bias0": torch.randn(D, generator=g),
           "oddly.named.basis0": torch.randn(NB, D, D, generator=g),
           "oddly.named.coeff0": torch.randn(kg.n_rels, NB, generator=g)}
    ckpt = str(tmp_path / "odd.pt")
    torch.save(odd, ckpt)
    key_map = {"emb.ent": {"key": "entity_table"},
               "emb.var": {"key": "var_table"},
               "layers.0.w_self": {"key": "oddly.named.self0"},
               "layers.0.bias": {"key": "oddly.named.bias0"},
               "layers.0.basis": {"key": "oddly.named.basis0"},
               "layers.0.coeff": {"key": "oddly.named.coeff0"}}
    map_path = str(tmp_path / "map.json")
    with open(map_path, "w") as f:
        json.dump(key_map, f)
    out = str(tmp_path / "odd_run")
    _quiet(timport.main, ["--ckpt", ckpt, "--out", out, "--map", map_path,
                          "--embed_dim", str(D), "--n_layers", "1",
                          "--num_bases", str(NB), "--device", "cpu"] + SYN)
    _, mc = tev.read_run_dir(out)
    assert mc["n_layers"] == 1 and mc["num_bases"] == NB
    with pytest.raises(SystemExit, match="only applies"):
        timport.main(["--ckpt", ckpt, "--out", out, "--num_bases", "4",
                      "--device", "cpu"] + SYN)


def test_imported_run_dir_serves_as_the_jax_server(tmp_path):
    """Per-mode tables and a shuffled node_maps through the import tool;
    the port's ``serve --run_dir --answer`` gives the JAX QueryServer's
    ids (scores within 1e-5) on JAX's import of the same file.  Full
    per-relation weights: both servers then encode in f32 (a basis model
    takes K3's bf16 products in the port, JAX's XLA path off the TPU)."""
    kg = jsamp.make_random_kg(n_entities=150, n_modes=3, n_base_rels=4,
                              n_triples=900, seed=2)
    d = str(tmp_path / "ds")
    os.makedirs(d)
    jload.save_graph_pickle(os.path.join(d, "graph_data.pkl"), kg)
    with open(os.path.join(d, "graph_data.pkl"), "rb") as f:
        rels, adj, node_maps = pickle.load(f)
    rng = np.random.default_rng(0)
    for m in node_maps:
        rng.shuffle(node_maps[m])
    with open(os.path.join(d, "graph_data.pkl"), "wb") as f:
        pickle.dump((rels, adj, node_maps), f)
    jkg, _, _ = jload.load_graph_pickle(os.path.join(d, "graph_data.pkl"))
    g = torch.Generator().manual_seed(4)
    sd = {"mode_embeddings.weight": torch.randn(jkg.n_modes, D, generator=g)}
    for m in jkg.mode_names:
        sd[f"enc.features.{m}.weight"] = torch.randn(len(node_maps[m]), D,
                                                     generator=g)
    for i in range(L):
        sd.update(_layer_keys(i, jkg.n_rels, None))
    ckpt = str(tmp_path / "ref.pt")
    torch.save(sd, ckpt)
    out = str(tmp_path / "imported")
    _quiet(timport.main, ["--ckpt", ckpt, "--out", out, "--data",
                          f"pkl:{d}", "--device", "cpu"])
    queries = jsamp.QuerySampler(jkg, seed=5)
    flat = [q for s in ("1-chain", "2-chain", "3-chain_inter")
            for q in queries.sample_queries(s, 6, n_neg=1)]
    pkl = str(tmp_path / "queries.pkl")
    jload.save_queries_pickle(pkl, flat)
    npz = str(tmp_path / "answers.npz")
    _quiet(tserve.main, ["--run_dir", out, "--device", "cpu", "--answer",
                         pkl, "--out", npz])
    got = np.load(npz)
    jparams, rep = jti.import_mpqe_params(
        jti.load_state_dict(ckpt), jm.MPQEConfig(
            n_entities=jkg.n_entities, n_modes=jkg.n_modes,
            n_rels=jkg.n_rels, embed_dim=D, n_layers=L, num_bases=None),
        jax.random.PRNGKey(0), mode_names=jkg.mode_names,
        node_maps=node_maps)
    assert not rep.missing
    grouped = jload.load_queries_pickle(pkl, jkg)
    ordered = [q for by_f in grouped.values() for qs in by_f.values()
               for q in qs]
    server = JaxServer(jparams, jm.MPQEConfig(
        n_entities=jkg.n_entities, n_modes=jkg.n_modes, n_rels=jkg.n_rels,
        embed_dim=D, n_layers=L, num_bases=None), jkg.entity_mode)
    with jax.default_matmul_precision("highest"):
        want = server.answer(ordered, k=10)
    np.testing.assert_array_equal(got["entity_ids"],
                                  np.stack([a.entity_ids for a in want]))
    np.testing.assert_allclose(got["scores"],
                               np.stack([a.scores for a in want]),
                               rtol=0, atol=1e-5)
