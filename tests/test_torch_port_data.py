"""The PyTorch port's host-side data layer against the JAX package's:
query templates, synthetic KGs, the query sampler and the batch helpers
must agree exactly, and the port must import no JAX."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpqe_tpu import queries as jq
from mpqe_tpu.data import batcher as jbatch
from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu_torch import queries as tq
from mpqe_tpu_torch.data import batcher as tbatch
from mpqe_tpu_torch.data import sampler as tsamp

# Torch's intra-op threads, capped for the whole test process: the
# tier-1 command runs 6 xdist workers on an 8-core machine, and a worker
# imports every test module at collection, so this one module-level call
# reaches every worker (and keeps the port's CPU-heavy tests from crowding
# the wall-clock race in tests/test_native.py).
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANONICAL = jq.STRUCTURE_NAMES  # the 7 templates (other tests may register more)


def test_structures_match():
    assert tq.STRUCTURE_NAMES == CANONICAL
    for name in CANONICAL:
        assert (dataclasses.asdict(tq.STRUCTURES[name])
                == dataclasses.asdict(jq.STRUCTURES[name])), name
    assert set(tq.CHAIN_STRUCTURES) == set(jq.CHAIN_STRUCTURES)
    assert {s for s in tq.INTERSECTION_STRUCTURES if s in CANONICAL} == {
        s for s in jq.INTERSECTION_STRUCTURES if s in CANONICAL}


@pytest.mark.parametrize("seed", [0, 3])
def test_make_random_kg_matches(seed):
    kw = dict(n_entities=250, n_modes=3, n_base_rels=5, n_triples=1500,
              seed=seed)
    a, b = jsamp.make_random_kg(**kw), tsamp.make_random_kg(**kw)
    for f in ("entity_mode", "rel_domain", "rel_range", "heads", "rels",
              "tails"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert (a.n_entities, a.n_base_rels) == (b.n_entities, b.n_base_rels)


@pytest.mark.parametrize("structure", list(CANONICAL))
def test_sampler_matches(structure):
    kw = dict(n_entities=300, n_modes=3, n_base_rels=6, n_triples=3000,
              seed=1)
    js = jsamp.QuerySampler(jsamp.make_random_kg(**kw), seed=5)
    ts = tsamp.QuerySampler(tsamp.make_random_kg(**kw), seed=5)
    for qa, qb in zip(js.sample_queries(structure, 6, n_neg=4),
                      ts.sample_queries(structure, 6, n_neg=4)):
        assert qa.formula.structure == qb.formula.structure
        assert qa.formula.rels == qb.formula.rels
        assert qa.formula.node_modes == qb.formula.node_modes
        assert (qa.anchors, qa.target) == (qb.anchors, qb.target)
        assert qa.neg_samples == qb.neg_samples
        assert qa.hard_neg_samples == qb.hard_neg_samples
    # the generators stay in step afterwards too
    assert js.rng.integers(1 << 30) == ts.rng.integers(1 << 30)


def test_batch_helpers_match():
    for n in (0, 1, 15, 16, 17, 255, 256, 257, 5000):
        assert tbatch.bucket_size(n) == jbatch.bucket_size(n)
        assert tbatch.bucket_size(n, 4) == jbatch.bucket_size(n, 4)
    rng = np.random.default_rng(0)
    for name in CANONICAL:
        spec_j, spec_t = jq.STRUCTURES[name], tq.STRUCTURES[name]
        for _ in range(5):
            # few relation ids, so same-relation edges into one slot occur
            rels = rng.integers(0, 2, spec_j.n_edges)
            np.testing.assert_array_equal(
                tbatch.template_edge_norm(spec_t, rels),
                jbatch.template_edge_norm(spec_j, rels))


def test_register_structure_uses_port_registry():
    name = "port-test-4-chain"
    try:
        spec = tq.register_structure(name, 1, 3, [(0, 1), (1, 2), (2, 3),
                                                 (3, 4)])
        assert tq.STRUCTURES[name] is spec
        assert spec.diameter == 4 and spec.target_slot == 4
        assert name not in jq.STRUCTURES
        with pytest.raises(ValueError):
            tq.register_structure(name, 1, 3, [(0, 1), (1, 2), (2, 3),
                                               (3, 4)])
        with pytest.raises(ValueError):
            tq.register_structure("port-test-bad", 1, 1, [(1, 0)])
    finally:
        tq.STRUCTURES.pop(name, None)
        tq.INTERSECTION_STRUCTURES.discard(name)


_NO_JAX = """
import sys, importlib, pkgutil
{imports}
bad = sorted(k for k in sys.modules
             if k in ("jax", "mpqe_tpu", "ml_dtypes")
             or k.startswith(("jax.", "mpqe_tpu.", "ml_dtypes.")))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def _run_isolated(imports: str):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", _NO_JAX.format(imports=imports)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_imports_no_jax():
    proc = _run_isolated(
        "import mpqe_tpu_torch\n"
        "import mpqe_tpu_torch.tools.dryrun_multichip\n"
        "import mpqe_tpu_torch.tools.am_scale_quality\n"
        "import mpqe_tpu_torch.tools.import_torch_checkpoint\n"
        "import mpqe_tpu_torch.tools.export_torch_checkpoint\n"
        "import mpqe_tpu_torch.tools.resilient_train\n"
        "for m in pkgutil.walk_packages(mpqe_tpu_torch.__path__, "
        "'mpqe_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('mpqe_tpu_torch.ops.segment_kernels', "
        "'mpqe_tpu_torch.ops.sddmm', 'mpqe_tpu_torch.evaluate', "
        "'mpqe_tpu_torch.parallel.halo', 'mpqe_tpu_torch.parallel.halo_train', "
        "'mpqe_tpu_torch.parallel.mesh', 'mpqe_tpu_torch.ops.ring', "
        "'mpqe_tpu_torch.netserve', 'mpqe_tpu_torch.data.native', "
        "'mpqe_tpu_torch.data.pipeline', 'mpqe_tpu_torch.ops.embed', "
        "'mpqe_tpu_torch.parallel.sharding', 'mpqe_tpu_torch.parallel.spmd', "
        "'mpqe_tpu_torch.parallel.multihost', "
        "'mpqe_tpu_torch.parallel.rank_shard', "
        "'mpqe_tpu_torch.data.torch_import', 'mpqe_tpu_torch.utils.debug', "
        "'mpqe_tpu_torch.utils.profiling'):\n"
        "    assert m in sys.modules, m\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_in_port_sources_or_chip_smoke():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "mpqe_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        for mod in _imported_names(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "mpqe_tpu", "ml_dtypes"), (
                path, mod)
    proc = _run_isolated("import chip_smoke\n")
    assert proc.returncode == 0, proc.stdout + proc.stderr
