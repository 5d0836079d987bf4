"""The port's elastic runtime against `repro.core.elastic`: mesh
re-planning, the failure timeline, and `ElasticRunner` recovering from an
injected failure (tests/test_elastic_data.py:37-57) to the params of an
uninterrupted run."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.elastic import FailureComponent as JFailure  # noqa: E402
from repro.core.elastic import plan_mesh_shape as jplan  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core.elastic import (ElasticRunner,  # noqa: E402
                                      FailureComponent, plan_mesh_shape)
from repro_torch.core.streaming_checkpoint import \
    StreamingCheckpointer  # noqa: E402
from repro_torch.data.pipeline import StorageNodeDataset  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import OptimizerConfig, adamw_init  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402


@pytest.mark.parametrize("want_pods", [1, 2])
def test_plan_mesh_shape_matches_reference(want_pods):
    for model in (1, 2, 4, 8, 16):
        for n in range(1, 1025):
            assert plan_mesh_shape(n, model=model, want_pods=want_pods) == \
                jplan(n, model=model, want_pods=want_pods), (n, model)
    # tests/test_elastic_data.py:16-20
    assert plan_mesh_shape(256) == (16, 16)
    assert plan_mesh_shape(512, want_pods=2) == (2, 16, 16)
    assert plan_mesh_shape(240) == (15, 16)
    assert plan_mesh_shape(8) == (1, 8)


def test_failure_component_matches_reference():
    for kw in ({}, {"ckpt_every": 4, "restore_s": 12.5, "replan_s": 2.0}):
        got, want = FailureComponent(**kw), JFailure(**kw)
        assert got.recovery_delay() == want.recovery_delay()
        assert [got.lost_steps(s) for s in range(40)] == \
            [want.lost_steps(s) for s in range(40)]


def _run(tmp_path, fail_at):
    """qwen3-32b smoke through ElasticRunner: 12 batches, a checkpoint at
    step 0 and every 4 steps, `fail_at` injected."""
    cfg = smoke_variant(get_config("qwen3-32b"))
    oc = OptimizerConfig(lr=1e-3)
    state = adamw_init(TM.init_params(torch.Generator().manual_seed(0),
                                      cfg), oc)
    ck = StreamingCheckpointer(tmp_path)
    ck.save(0, state)
    step = make_train_step(cfg, oc)
    made = []

    def make_step(mesh):
        made.append(mesh)
        return step

    ds = StorageNodeDataset(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=2, n_storage_nodes=2)
    batches = [{k: torch.from_numpy(v) for k, v in ds.fetch_step(i).items()}
               for i in range(12)]
    runner = ElasticRunner(make_step=make_step, init_state=state,
                           checkpointer=ck, ckpt_every=4)
    return runner, runner.run(batches, fail_at=fail_at), made


def test_elastic_runner_recovers_from_failure(tmp_path):
    """As tests/test_elastic_data.py:37-57: a failure at step 6 restores
    the step-4 checkpoint, re-plans the step (make_step(None) again) and
    replays steps 4-5; the run ends at step 12 with the params of an
    uninterrupted run, bit for bit."""
    runner, final, made = _run(tmp_path / "failed", {6: 16})
    assert runner.recoveries == 1
    assert final.step == 12 and runner.steps_done == 14
    assert made == [None, None]
    straight, clean, _ = _run(tmp_path / "clean", None)
    assert straight.recoveries == 0 and straight.steps_done == 12
    for a, b in zip(tree_leaves(final.params), tree_leaves(clean.params)):
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())
    assert StreamingCheckpointer(tmp_path / "failed").all_steps() == \
        [4, 8, 12]
