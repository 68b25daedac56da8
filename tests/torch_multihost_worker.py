"""Worker program of tests/test_torch_multihost.py: one process of an
N-process torch.distributed job (gloo, localhost, CPU shards), the port's
counterpart of tests/multihost_worker.py.  Not a pytest module.

Usage: python torch_multihost_worker.py <rank> <world> <port> <data_dir> [mode]

mode 'engine' (default): this process's cell slice of counts.npy through
io/sharded.py, the sharded median and group statistics, and the engine's
full_chunk over the global mesh; writes this process's rows.
mode 'run': the whole run() over the global mesh (every process holds the
whole object, as the reference's worker does); each writes its reports.

It imports neither JAX nor the JAX package.
"""

import json
import os
import sys

import numpy as np

#: CPU shards a process
SHARDS = 2


def build_run_object(data_dir, meta):
    """The run()-level object of counts.npy (both the workers and the
    single-process runs of the test build it so)."""
    from infercnv_tpu_torch.core.object import create_infercnv_object

    counts = np.load(os.path.join(data_dir, "counts.npy"))  # [C, G]
    C, G, n_ref = meta["C"], meta["G"], meta["n_ref"]
    gene_names = [f"g{i}" for i in range(G)]
    cell_names = [f"c{i}" for i in range(C)]
    ann = {c: ("normal" if i < n_ref else "tumor")
           for i, c in enumerate(cell_names)}
    table = {g: (meta["chr_names"][meta["chr_ids"][i]], meta["start"][i],
                 meta["stop"][i]) for i, g in enumerate(gene_names)}
    return create_infercnv_object(
        counts_matrix=counts.T, gene_names=gene_names, cell_names=cell_names,
        annotations=ann, gene_order_table=table,
        chr_file_order=meta["chr_names"], ref_group_names=["normal"],
        chr_exclude=(), min_max_counts_per_cell=(1, np.inf))


#: run()'s arguments in 'run' mode (the i3 HMM and the qnorm partition
#: draw nothing, so the single-process runs of both packages are held to
#: the same numbers)
RUN_KW = dict(analysis_mode="subclusters", tumor_subcluster_partition_method="qnorm",
              HMM=True, HMM_type="i3", denoise=True, save_rds=False,
              save_final_rds=False, no_prelim_plot=True, BayesMaxPNormal=0)


def main() -> None:
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    data_dir = sys.argv[4]
    mode = sys.argv[5] if len(sys.argv) > 5 else "engine"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        with open(os.path.join(data_dir, "meta.json")) as f:
            meta = json.load(f)
        from infercnv_tpu_torch.parallel.stats import CellMesh

        mesh = CellMesh(["cpu"] * SHARDS, group=dist.group.WORLD)
        if mode == "run":
            _run(rank, data_dir, meta, mesh)
        else:
            _engine(rank, data_dir, meta, mesh)
    finally:
        dist.destroy_process_group()


def _engine(rank, data_dir, meta, mesh) -> None:
    from infercnv_tpu_torch.core.genome import GeneOrder
    from infercnv_tpu_torch.io.sharded import global_cell_array, load_counts_shard
    from infercnv_tpu_torch.models.hmm import HMMParams
    from infercnv_tpu_torch.parallel.engine import CnvEngine, EngineConfig
    from infercnv_tpu_torch.parallel.stats import (
        sharded_group_gene_stats,
        sharded_median,
        to_host,
    )

    C, G, n_ref = meta["C"], meta["G"], meta["n_ref"]
    # 1. this process's cell slice (host_id / n_hosts from the group)
    local, _genes, _cells, (lo, hi) = load_counts_shard(
        os.path.join(data_dir, "counts.npy"))
    assert local.shape[0] == hi - lo
    counts = global_cell_array(local, mesh, C)
    # 2. the sharded exact median of the library sizes
    lib = global_cell_array(local.sum(axis=1).astype(np.float32), mesh, C)
    norm_factor = float(sharded_median(lib, mesh))
    # 3. the reference group's gene means and sds over every process
    onehot = np.zeros((hi - lo, 1), np.float32)
    onehot[np.arange(lo, hi) < n_ref, 0] = 1.0
    gmeans, gsds = sharded_group_gene_stats(
        counts, global_cell_array(onehot, mesh, C), mesh)
    # 4. the engine over the global mesh
    go = GeneOrder(
        names=tuple(f"g{i}" for i in range(G)),
        chr_names=tuple(meta["chr_names"]),
        chr_ids=np.asarray(meta["chr_ids"], np.int32),
        start=np.asarray(meta["start"]), stop=np.asarray(meta["stop"]))
    params = HMMParams(means=np.arange(1.0, 7.0) / 3.0, sds=np.full(6, 0.1), t=1e-6)
    engine = CnvEngine(go, params, EngineConfig(window_length=meta["window"],
                                                denoise=False), mesh=mesh)
    ref_rows = to_host(counts)[:n_ref]      # gathered from every process
    ml, mr, nb = engine.ref_stats(ref_rows, norm_factor)
    resid, states = engine.full_chunk(counts, norm_factor, ml, mr, nb)
    import torch

    np.savez(os.path.join(data_dir, f"out_host{rank}.npz"),
             resid=torch.cat(resid.shards).numpy(),
             states=torch.cat(states.shards).numpy(),
             start=mesh.first_shard * resid.shards[0].shape[0],
             norm_factor=norm_factor, gmeans=gmeans.numpy(), gsds=gsds.numpy(),
             all_states=to_host(states))
    print(f"rank {rank}: OK rows [{lo}, {hi})", flush=True)


def _run(rank, data_dir, meta, mesh) -> None:
    from infercnv_tpu_torch.runner.pipeline import run

    obj = build_run_object(data_dir, meta)
    res = run(obj, out_dir=os.path.join(data_dir, f"run_host{rank}"), mesh=mesh,
              device="cpu", window_length=meta["window"], no_plot=True,
              **RUN_KW)
    np.savez(os.path.join(data_dir, f"run_out_host{rank}.npz"),
             expr=np.asarray(res.infercnv_obj.expr),
             states=np.asarray(res.hmm_states))
    print(f"rank {rank}: run() OK", flush=True)


if __name__ == "__main__":
    main()
