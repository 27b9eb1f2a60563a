"""Test order and thread pools for the whole suite.

Order: with ``-p xdist --dist loadfile`` each worker runs whole files, and
xdist by default queues the files by their number of tests, most first
(``--loadscope-reorder``). Heavy files that hold few tests then start last
and make the run's tail. Here the reordering is turned off and the items
are sorted file by file, heaviest file first, by ``FILE_SECONDS``; the sort
is stable, so each file keeps its own order, and files missing from the
table go last in collection order. Nothing is deselected, skipped or
marked.

Thread pools: six workers share eight cores, and each worker's OpenBLAS
pool would start a thread a core; oversubscribed, those threads spin and
yield against each other. So OpenBLAS (and OpenMP) get one thread a
process, set here before the workers start and import numpy (a variable
already set is kept). XLA's CPU pool keeps its default: one thread would
repartition its contractions, and the changed rounding flips three
knife-edge tests of the JAX package (``test_cvar_solver.py::
test_cvar_ipm_gondzio_oracle_and_hard_batch``, ``test_batched_env.py::
test_batched_merge_matches_host_env``, ``::
test_batched_merge_step_teacher_forced``), which pass with the BLAS limit.

``FILE_SECONDS``: each file's summed test seconds (setup and teardown
included) in one full run of ROADMAP.md's tier-1 command on an 8-core
CPU machine (6 workers; its time limit raised so that the run reached its
end: 1,754 s, 356 passed), tabulated by
``python scripts/tier1_file_seconds.py <junit xml>``; the two slice-9 files
(``test_torch_batched_highway.py``, ``test_torch_host_envs.py``) from a
later full run of the same command (839.6 s, 389 passed); the seven slice-10
files (``test_torch_tree_admm.py``, ``test_torch_admm_oracle.py``,
``test_torch_admm_mpc.py``, ``test_torch_robust_mpc.py``,
``test_torch_hmm.py``, ``test_torch_hmm_admm.py``,
``test_torch_quad_env.py``) from a later one (917.6 s, 435 passed); the
five slice-11 files (``test_torch_parallel.py``, ``test_torch_examples.py``,
``test_torch_tree_shard.py``, ``test_torch_utils.py``,
``test_torch_viz.py``) from a later one (912.6 s, 487 passed); the three
slice-12 files (``test_torch_cvar_diag_options.py``,
``test_torch_lane_refline.py``, ``test_torch_port_scripts.py``) from
each file run alone; ``test_torch_port_scripts.py`` again and the slice-13
file ``test_torch_study_scripts.py`` from a later full run (956.1 s, 514
passed).

This file imports neither jax nor torch.
"""

import os

os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
os.environ.setdefault("OMP_NUM_THREADS", "1")

FILE_SECONDS = {
    "tests/test_controller_parity.py": 1713.7,
    "tests/test_cvar_pl.py": 1097.9,
    "tests/test_tree_qp.py": 994.8,
    "tests/test_cvar_solver.py": 744.6,
    "tests/test_quadruped_parity.py": 451.6,
    "tests/test_tree_engine.py": 431.3,
    "tests/test_parallel.py": 324.6,
    "tests/test_hmm.py": 279.9,
    "tests/test_batched_env.py": 251.0,
    "tests/test_cvar_controller.py": 207.9,
    "tests/test_tree_qp_pl.py": 200.5,
    "tests/test_envs.py": 180.2,
    "tests/test_distributed.py": 121.6,
    "tests/test_viz.py": 117.6,
    "tests/test_robust_mpc.py": 110.8,
    "tests/test_torch_cvar_ipm.py": 92.4,
    "tests/test_torch_host_envs.py": 88.3,
    "tests/test_torch_ipm_steps.py": 86.3,
    "tests/test_ops_models.py": 80.6,
    "tests/test_native_qp.py": 75.7,
    "tests/test_torch_qp_ipm.py": 75.5,
    "tests/test_torch_batched_highway.py": 73.1,
    "tests/test_torch_cvar_refine.py": 68.8,
    "tests/test_torch_cvar_pl.py": 66.7,
    "tests/test_torch_cvar_mpc.py": 60.2,
    "tests/test_torch_tree_qp_pl.py": 60.2,
    "tests/test_cvar_oracle.py": 56.1,
    "tests/test_subsystems.py": 50.4,
    "tests/test_torch_admm_mpc.py": 53.0,
    "tests/test_torch_quadruped.py": 46.1,
    "tests/test_torch_tree_admm.py": 41.6,
    "tests/test_torch_robust_mpc.py": 53.7,
    "tests/test_torch_hmm.py": 57.0,
    "tests/test_torch_quad_env.py": 34.9,
    "tests/test_torch_admm_oracle.py": 9.1,
    "tests/test_torch_hmm_admm.py": 10.7,
    "tests/test_torch_parallel.py": 50.0,
    "tests/test_torch_examples.py": 50.2,
    "tests/test_torch_tree_shard.py": 33.0,
    "tests/test_torch_utils.py": 7.6,
    "tests/test_torch_viz.py": 4.7,
    "tests/test_torch_cvar_diag_options.py": 68.3,
    "tests/test_torch_lane_refline.py": 23.9,
    "tests/test_torch_port_scripts.py": 28.8,
    "tests/test_torch_study_scripts.py": 64.9,
    "tests/test_torch_branch_mpc.py": 43.1,
    "tests/test_torch_kernel_cpu_build.py": 31.8,
    "tests/test_torch_cvar_admm.py": 31.2,
    "tests/test_torch_batched_merge.py": 28.3,
    "tests/test_torch_tree.py": 21.0,
    "tests/test_torch_cvar_formulas.py": 19.1,
    "tests/test_torch_tree_lqr.py": 16.4,
    "tests/test_torch_formulas.py": 13.8,
    "tests/test_torch_cvar_kernel_cpu_build.py": 12.0,
    "tests/test_torch_imports.py": 9.0,
    "tests/test_torch_shared_rows.py": 6.1,
    "tests/test_torch_soc_kernel_cpu_build.py": 3.2,
    "tests/test_pallas_kernels.py": 2.2,
    "tests/test_torch_cuda.py": 0.0,
    "tests/test_golden_traces.py": 0.0,
}


def pytest_configure(config):
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(session, config, items):
    def heaviest_first(item):
        sec = FILE_SECONDS.get(item.nodeid.split("::", 1)[0])
        return (1, 0.0) if sec is None else (0, -sec)

    items.sort(key=heaviest_first)
