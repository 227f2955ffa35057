"""The (data, member) layout at (2, 2): one four-rank ``gloo`` world on the
CPU (``tests/torch_parallel_world22.py``, spawned once under its own
timeout) runs the inference job over a four-checkpoint ensemble (TTA, two
rounds a member: each rank two images and two members) and a four-member
HRNet stack (stage and final dropout, TTA), each beside the single process
on the same seed, which they equal to the jobs' atol 1e-5. The MC-dropout
job has no member axis in either package (its members share one
checkpoint, so ``_resolve_mesh`` refuses a member axis without a stacked
source): the HRNet stack carries the dropout. The two-rank world and the
helpers are ``test_torch_port_parallel.py``'s."""

import pytest

from diffuncertainty_tpu_torch.data.toy import generate_toy_dataset
from test_torch_port_parallel import assert_same_results, checkpoint, report, run_world
from torch_threads import one_torch_thread  # noqa: F401

RANKS = 4


@pytest.fixture(scope="module")
def world22(tmp_path_factory):
    work = tmp_path_factory.mktemp("world22")
    generate_toy_dataset(work / "toy", num_train=4, num_val=2, num_test=8, num_ood=2,
                         num_raters=3, size=32, seed=0)
    for i in range(4):
        checkpoint(work, f"ckpt_ens{i}", "none", 20 + i)
    return run_world(work, "torch_parallel_world22.py", RANKS)


def test_the_ensemble_job_at_2_2_equals_the_single_process_job(world22):
    assert report(world22, "dm22_mesh") == {"data": 2, "member": 2}
    assert report(world22, "ref_mesh") is None
    # two of the four members a rank, in one folded block
    assert report(world22, "dm22_blocks") == [2] and report(world22, "ref_blocks") == [4]
    assert [rep["dm22_summary"]["n_images"] for rep in world22["reports"]] == [8] * RANKS
    assert_same_results(world22["work"] / "ref", world22["work"] / "dm22")


def test_the_hrnet_stack_at_2_2_equals_the_single_process_stack(world22):
    assert report(world22, "hrnet_shape") == (4, 2, 2, 32, 32, 2)
    assert report(world22, "hrnet_single_blocks") == [1, 1, 1, 1]
    assert report(world22, "hrnet_dm22_blocks") == [1, 1]  # its two members, one a block
    assert [rep["hrnet_dm22_max_diff"] <= 1e-5 for rep in world22["reports"]] == [True] * RANKS
    assert report(world22, "hrnet_member_spread") > 1e-3


def test_only_rank_0_writes_at_2_2(world22):
    assert report(world22, "writes") == {"results": 2}  # one writer a job
    assert [rep["writes"] for rep in world22["reports"][1:]] == [{"results": 0}] * (RANKS - 1)
