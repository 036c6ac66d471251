"""The port's copies of the taxonomy tree, the taxonomy artifact loader and
the hierarchical-consistency pass against the TPU package's, on seeded
random hierarchies and results. Everything here is exact: the two sides run
the same integer logic on the same inputs.
"""

import json

import numpy as np
import pytest

from linnaeus_tpu.inference import artifacts as jart
from linnaeus_tpu.inference import postprocessing as jpost
from linnaeus_tpu.inference import schemas as jschemas
from linnaeus_tpu.utils.taxonomy import TaxonomyTree as JTree
from linnaeus_tpu_torch.inference import artifacts as tart
from linnaeus_tpu_torch.inference import postprocessing as tpost
from linnaeus_tpu_torch.inference import schemas as tschemas
from linnaeus_tpu_torch.utils.taxonomy import TaxonomyTree

TASKS = ["taxa_L10", "taxa_L20", "taxa_L30", "taxa_L40"]  # fine -> coarse


def _hierarchy(seed, sizes=(40, 14, 6, 3), orphan_rate=0.1):
    """A random forest: every class of a level gets a parent in the next
    coarser level, except class 0 (the null class) and a few orphans. Keys
    are strings, as a JSON file gives them."""
    rng = np.random.default_rng(seed)
    num_classes = dict(zip(TASKS, sizes))
    hmap = {}
    for child, parent in zip(TASKS[:-1], TASKS[1:]):
        level = {}
        for c in range(1, num_classes[child]):
            if rng.random() >= orphan_rate:
                level[str(c)] = int(rng.integers(1, num_classes[parent]))
        hmap[child] = level
    return hmap, num_classes


@pytest.fixture(params=[0, 1, 2], ids=lambda s: f"seed{s}")
def trees(request):
    hmap, num_classes = _hierarchy(request.param)
    return JTree(hmap, TASKS, num_classes), TaxonomyTree(hmap, TASKS, num_classes)


def test_graph_queries_match(trees):
    theirs, ours = trees
    assert ours.task_keys == theirs.task_keys and ours.num_classes == theirs.num_classes
    assert ours.roots == theirs.roots and ours.leaves == theirs.leaves
    assert ours.num_levels == theirs.num_levels == 4
    for task in TASKS:
        assert ours.get_nodes_at_level(task) == theirs.get_nodes_at_level(task)
        for node in theirs.get_nodes_at_level(task):
            assert ours.get_parent(node) == theirs.get_parent(node)
            assert ours.get_children(node) == theirs.get_children(node)
            assert ours.get_ancestors(node) == theirs.get_ancestors(node)
            assert ours.get_descendants(node) == theirs.get_descendants(node)
            assert ours.get_siblings(node) == theirs.get_siblings(node)
            assert ours.get_root(node) == theirs.get_root(node)
    rng = np.random.default_rng(3)
    for _ in range(50):
        a = (TASKS[rng.integers(4)], int(rng.integers(3)))
        b = (TASKS[rng.integers(4)], int(rng.integers(3)))
        assert ours.get_distance(a, b) == theirs.get_distance(a, b)
    assert repr(ours) == repr(theirs)


def test_hierarchy_and_distance_matrices_match(trees):
    theirs, ours = trees
    want, got = theirs.build_hierarchy_matrices(), ours.build_hierarchy_matrices()
    assert list(got) == list(want) == ["taxa_L20_taxa_L10", "taxa_L30_taxa_L20",
                                       "taxa_L40_taxa_L30"]
    for key in want:
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key])
        assert (got[key].sum(axis=0) <= 1).all()  # one parent at most
    for task in TASKS[1:]:
        np.testing.assert_array_equal(ours.build_distance_matrix(task),
                                      theirs.build_distance_matrix(task))


def test_save_load_round_trip_and_artifact_loader(trees, tmp_path):
    theirs, ours = trees
    ours.save(str(tmp_path / "ours" / "tree.json"))
    theirs.save(str(tmp_path / "theirs.json"))
    assert json.loads((tmp_path / "ours" / "tree.json").read_text()) == json.loads(
        (tmp_path / "theirs.json").read_text())
    # each side reads the other's file
    crossed = TaxonomyTree.load(str(tmp_path / "theirs.json"))
    assert crossed._child_to_parent == ours._child_to_parent
    assert JTree.load(str(tmp_path / "ours" / "tree.json"))._child_to_parent == \
        theirs._child_to_parent
    data = tart.load_taxonomy_tree_artifact(tmp_path / "theirs.json", "CoL2024", "v1", 7)
    want = jart.load_taxonomy_tree_artifact(tmp_path / "theirs.json", "CoL2024", "v1", 7)
    assert (data.source, data.version, data.root_id, data.linnaeus_task_keys) == (
        want.source, want.version, want.root_id, want.linnaeus_task_keys)
    assert data.taxonomy_tree._child_to_parent == theirs._child_to_parent
    with pytest.raises(FileNotFoundError, match="Taxonomy tree file not found"):
        tart.load_taxonomy_tree_artifact(tmp_path / "missing.json")


def test_malformed_maps_are_handled_alike():
    hmap = {"taxa_L10": {"1": 1, "2": "x", "99": 1, "3": 50}, "taxa_L20": [1, 2]}
    num_classes = {"taxa_L10": 4, "taxa_L20": 3}
    theirs = JTree(hmap, TASKS[:2], num_classes)
    ours = TaxonomyTree(hmap, TASKS[:2], num_classes)
    assert ours._child_to_parent == theirs._child_to_parent
    assert ours.get_parent(("taxa_L10", 1)) == ("taxa_L20", 1)
    with pytest.raises(KeyError):
        TaxonomyTree({}, TASKS[:2], {"taxa_L10": 2})


# ------------------------------------------- the hierarchical-consistency pass
def _maps(num_classes, null_idx=0):
    """Class maps with taxon ids 1000 * rank + class index, the null class
    at index 0 of every rank, on both sides."""
    raw = {t: {str(i): 1000 * tart.rank_level_from_task_key(t) + i for i in range(n)}
           for t, n in num_classes.items()}
    ours = tart.class_index_maps(raw, TASKS, [num_classes[t] for t in TASKS],
                                 dict.fromkeys(TASKS, null_idx))
    theirs = jart.ClassIndexMapData(
        idx_to_taxon_id=ours.idx_to_taxon_id, taxon_id_to_idx=ours.taxon_id_to_idx,
        null_taxon_ids=ours.null_taxon_ids, num_classes_per_rank=ours.num_classes_per_rank)
    return ours, theirs


def _result(schemas, tops, maps, k=3):
    """A result whose task t has class index tops[t] on top, then k - 1 others."""
    tasks = []
    for task, top in zip(TASKS, tops):
        rank = tart.rank_level_from_task_key(task)
        n = maps.num_classes_per_rank[rank]
        idx = [top] + [i for i in range(n) if i != top][:k - 1]
        probs = [0.6, 0.3, 0.1][:len(idx)]
        tasks.append(schemas.TaskPrediction(
            rank_level=rank, task_key=task,
            predictions=[(maps.idx_to_taxon_id[rank][i], p) for i, p in zip(idx, probs)]))
    return schemas.HierarchicalClassificationResult(
        taxonomy_context={"source": "CoL2024", "version": None, "root": None}, tasks=tasks)


def _both(seed):
    hmap, num_classes = _hierarchy(seed, orphan_rate=0.0)
    ours_maps, their_maps = _maps(num_classes)
    ours_tax = tart.taxonomy_data(TaxonomyTree(hmap, TASKS, num_classes), "CoL2024")
    tree = JTree(hmap, TASKS, num_classes)
    their_tax = jart.TaxonomyData(taxonomy_tree=tree, source="CoL2024",
                                  linnaeus_task_keys=tree.task_keys)
    return ours_tax, ours_maps, their_tax, their_maps


def _run_both(tops, seed=0):
    ours_tax, ours_maps, their_tax, their_maps = _both(seed)
    got = tpost.enforce_hierarchical_consistency(
        _result(tschemas, tops, ours_maps), ours_tax, ours_maps)
    want = jpost.enforce_hierarchical_consistency(
        _result(jschemas, tops, their_maps), their_tax, their_maps)
    assert got.taxonomy_context == want.taxonomy_context
    assert [(t.rank_level, t.task_key, [tuple(p) for p in t.predictions]) for t in got.tasks] == \
        [(t.rank_level, t.task_key, [tuple(p) for p in t.predictions]) for t in want.tasks]
    return got, ours_tax.taxonomy_tree, ours_maps


def _chain(tree, leaf):
    """Class indices fine -> coarse of the leaf's line of ancestors."""
    node = ("taxa_L10", leaf)
    return [leaf] + [n[1] for n in tree.get_ancestors(node)]


def test_a_consistent_result_is_left_alone():
    hmap, num_classes = _hierarchy(0, orphan_rate=0.0)
    tops = _chain(TaxonomyTree(hmap, TASKS, num_classes), 5)
    got, _, maps = _run_both(tops)
    assert [t.predictions[0][0] for t in got.tasks] == [
        maps.idx_to_taxon_id[r][i] for r, i in zip((10, 20, 30, 40), tops)]
    assert all(len(t.predictions) == 3 for t in got.tasks)


def test_a_null_at_a_coarse_rank_nulls_every_finer_rank():
    hmap, num_classes = _hierarchy(0, orphan_rate=0.0)
    tops = _chain(TaxonomyTree(hmap, TASKS, num_classes), 5)
    tops[2] = 0  # null at taxa_L30
    got, _, maps = _run_both(tops)
    fine, l20, l30, l40 = got.tasks
    assert fine.predictions == [(maps.null_taxon_ids[10], 1.0)]
    assert l20.predictions == [(maps.null_taxon_ids[20], 1.0)]
    assert l30.predictions[0][0] == maps.null_taxon_ids[30] and len(l30.predictions) == 3
    assert l40.predictions[0][0] == maps.idx_to_taxon_id[40][tops[3]]


def test_an_inconsistent_child_is_nulled_with_everything_below_it():
    hmap, num_classes = _hierarchy(0, orphan_rate=0.0)
    tree = TaxonomyTree(hmap, TASKS, num_classes)
    tops = _chain(tree, 5)
    # a genus whose parent is another family than the one on top
    wrong = next(i for i in range(1, num_classes["taxa_L20"])
                 if tree.get_parent(("taxa_L20", i)) != ("taxa_L30", tops[2]))
    tops[1] = wrong
    got, _, maps = _run_both(tops)
    assert got.tasks[0].predictions == [(maps.null_taxon_ids[10], 1.0)]
    assert got.tasks[1].predictions == [(maps.null_taxon_ids[20], 1.0)]
    assert got.tasks[2].predictions[0][0] == maps.idx_to_taxon_id[30][tops[2]]


@pytest.mark.parametrize("seed", range(6))
def test_random_results_match(seed):
    """Random top classes at every rank, nulls and orphans' gaps included."""
    rng = np.random.default_rng(100 + seed)
    _, num_classes = _hierarchy(seed, orphan_rate=0.0)
    for _ in range(25):
        tops = [int(rng.integers(0, num_classes[t])) for t in TASKS]
        got, tree, maps = _run_both(tops, seed)
        # what comes out obeys the tree: below the coarsest rank a top taxon
        # is null or a child of the coarser rank's top taxon
        for fine, coarse in zip(got.tasks[:-1], got.tasks[1:]):
            top_f, top_c = fine.predictions[0][0], coarse.predictions[0][0]
            if top_f == maps.null_taxon_ids[fine.rank_level]:
                continue
            assert top_c != maps.null_taxon_ids[coarse.rank_level]
            child = (fine.task_key, maps.taxon_id_to_idx[fine.rank_level][top_f])
            parent = (coarse.task_key, maps.taxon_id_to_idx[coarse.rank_level][top_c])
            assert tree.get_parent(child) == parent


def test_an_empty_result_passes_through():
    ours_tax, ours_maps, _, _ = _both(0)
    empty = tschemas.HierarchicalClassificationResult()
    assert tpost.enforce_hierarchical_consistency(empty, ours_tax, ours_maps) is empty
