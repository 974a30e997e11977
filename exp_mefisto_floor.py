"""How far MEFISTO's dense fits over a (2, 2) mesh drift from one device's
over 100 sweeps, beside how far one device drifts from itself when only the
float32 order of its feature sums changes (each view's features permuted:
the same model).

Run on a machine with a CUDA card, from the root of the repo:

    python3 exp_mefisto_floor.py

Four ranks under gloo share card 0, as chip_smoke.py's [mesh4] does. For
chip_smoke.py's ``model_groups`` and warping fits (3,000 cells in 2 groups,
views of 500 and 800, K = 10, 100 sweeps, the hyperparameters refreshed
every 25 sweeps from sweep 20, the warp every 20) it prints, for the mesh fit
and for the permuted refit, the largest relative gap of their ELBOs to the
single device's over the first 30, 50 and 100 sweeps, and after sweep 100
the gap of Kg on the active factors, of the warped covariate, and how many
factors' ℓ and s differ. chip_smoke.py gates its mesh fits at 30 sweeps;
this reads what lies past them.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs

SWEEPS, DEPTHS, P = 100, (30, 50, 100), 4
CASES = ("mefisto_groups", "mefisto_warp")


def outputs(res) -> dict:
    out = dict(elbo=res.elbo_history, Z=res.Z, ell=res.gp_lengthscales, scale=res.gp_scales)
    if res.gp_group_corr is not None:
        out["Kg"] = res.gp_group_corr
    if res.warped_covariates is not None:
        out["warped"] = res.warped_covariates
    return out


def gaps(got: dict, ref: dict) -> dict:
    rel = np.abs(got["elbo"] - ref["elbo"]) / np.abs(ref["elbo"])
    out = {f"elbo_{d}": float(rel[:d].max()) for d in DEPTHS}
    if "Kg" in ref:
        keep = ref["Z"].std(axis=0) > 0.05 * ref["Z"].std(axis=0).max()
        out[f"Kg_{SWEEPS}"] = float(np.abs(got["Kg"][keep] - ref["Kg"][keep]).max())
    if "warped" in ref:
        out[f"warped_{SWEEPS}"] = float(np.abs(got["warped"] - ref["warped"]).max())
    out["ell_apart"] = int((got["ell"] != ref["ell"]).sum())
    out["scale_apart"] = int((got["scale"] != ref["scale"]).sum())
    return out


def rank_main(rank, store, work):
    import torch.distributed as dist

    from muon_tpu_torch import parallel as par
    from muon_tpu_torch.models import mofa as tm

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=P)
    try:
        mesh = par.make_mesh(P, device="cuda:0")
        for case in CASES:
            data = cs.mefisto_data(**cs.MEF_CASES[case][0])
            res = cs.mefisto_fit(tm, case, data, SWEEPS, mesh=mesh)
            if rank == 0:
                np.savez(f"{work}/{case}_mesh.npz", **outputs(res))
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_mefisto_floor: needs a CUDA device", file=sys.stderr)
        return 1
    import torch.multiprocessing as mp

    from muon_tpu_torch.models import mofa as tm

    cuda = torch.device("cuda", 0)
    print(f"[device] {torch.cuda.get_device_name(0)}", flush=True)
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        mp.spawn(rank_main, args=(f"{work}/store", work), nprocs=P)
        print(f"[mesh] {P} ranks, {len(CASES)} fits of {SWEEPS} sweeps in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        for case in CASES:
            data = cs.mefisto_data(**cs.MEF_CASES[case][0])
            one = outputs(cs.mefisto_fit(tm, case, data, SWEEPS, device=cuda))
            permuted = outputs(cs.mefisto_fit(tm, case, cs.permuted_features(data), SWEEPS,
                                              device=cuda))
            mesh = dict(np.load(f"{work}/{case}_mesh.npz"))
            print(json.dumps({"case": case, "mesh": gaps(mesh, one),
                              "permuted": gaps(permuted, one)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
