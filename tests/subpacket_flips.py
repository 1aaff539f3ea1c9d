"""Hold the lanes where the port's subpacket kernel and its cluster kernel
disagree against the reference's own subpacket kernel.

chip_smoke.py writes chiprun_out/subpacket_flips.npz on the card: for its
mesh-heavy camera and bounce-1 rays and its 8,000-triangle soup, every
lane whose subpacket closest hit differs from the cluster kernel's (a hit
/ miss flip or another slot), with the ray, both kernels' answers and a
SHA-256 digest of the 8-wide and Woop tables. This script rebuilds the same
tables on the CPU with the port's compiler (testing.mesh_heavy at full
size with the opt-in routes on, and chip_smoke.soup_case), checks the
digests, and runs those rays through luisarender_tpu's
`trace_closest_subpacket` in interpret mode over the same tables, and
through the port's plain version on the CPU (`ops/subpacket.py
closest_plain`, the code of this tree). It also tests each lane's two
candidate triangles (the subpacket and the cluster winner) in float64
Moller-Trumbore, whose least of u, v, 1 - u - v says how far inside (> 0)
or outside (< 0) the triangle the ray passes.

    python tests/subpacket_flips.py [chiprun_out/subpacket_flips.npz]

Without an argument it reads tests/data/subpacket_flips_mesh_heavy.npz,
the lanes of one chip_smoke.py run on an H100 (7 camera lanes).

Prints one JSON line a lane and a summary line last: the lanes where the
reference's kernel takes the card's subpacket slot and t, and where it
takes the plain version's. Needs ~1 GB and ~1 minute of CPU.
"""

import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import hashlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import luisarender_tpu_torch as lt  # noqa: E402
from luisarender_tpu.core.types import Ray  # noqa: E402
from luisarender_tpu.ops import subpacket_pallas  # noqa: E402
from luisarender_tpu_torch import testing  # noqa: E402
from luisarender_tpu_torch.ops import cluster, subpacket, wide8  # noqa: E402

TABLES = ("cluster_slab8", "cluster_meta8", "cluster_woop")


def mesh_heavy_tables():
    subpacket.ENABLED = wide8.ENABLED = True
    scene = lt.Scene.from_dict(testing.mesh_heavy(**chip_smoke.MESH_HEAVY))
    tr = lt.compile_scene(scene, device="cpu").arrays["trace"]
    return {k: v.numpy() for k, v in tr.items()}


def soup_tables():
    _, tr = chip_smoke.soup_case(torch, cluster, "cpu", 8000, 100_003, seed=6, trees=True)
    return {k: v.numpy() for k, v in tr.items()}


def mt64(o, d, v0, e1, e2):
    """float64 Moller-Trumbore: (t, least of u, v and 1 - u - v)."""
    o, d, v0, e1, e2 = (np.asarray(x, np.float64) for x in (o, d, v0, e1, e2))
    p = np.cross(d, e2)
    det = np.dot(e1, p)
    tv = o - v0
    u = np.dot(tv, p) / det
    q = np.cross(tv, e1)
    v = np.dot(d, q) / det
    return float(np.dot(e2, q) / det), float(min(u, v, 1.0 - u - v))


def main(path):
    data = np.load(path)
    built = {}
    lanes, same_card, same_plain = 0, 0, 0
    for case in ("camera", "bounce1", "soup8000"):
        if f"{case}/lane" not in data or data[f"{case}/lane"].size == 0:
            continue
        key = "soup" if case == "soup8000" else "mesh_heavy"
        if key not in built:
            built[key] = soup_tables() if key == "soup" else mesh_heavy_tables()
        tr = built[key]
        for k in TABLES:
            digest = hashlib.sha256(np.ascontiguousarray(tr[k]).tobytes()).hexdigest()
            want = str(data[f"{'soup8000' if key == 'soup' else 'camera'}/sha256_{k}"])
            if digest != want:
                raise SystemExit(f"{case}: {k} differs from the card's table")
        o, d, t_min, t_max = (data[f"{case}/{k}"] for k in ("o", "d", "t_min", "t_max"))
        ref = subpacket_pallas.trace_closest_subpacket(
            *(jnp.asarray(tr[k]) for k in TABLES),
            Ray(*(jnp.asarray(x) for x in (o, d, t_min, t_max))), interpret=True)
        ref_t, ref_slot = np.asarray(ref.t), np.asarray(ref.prim)
        plain_t, plain_slot = (x.numpy() for x in subpacket.closest_plain(
            *(torch.as_tensor(x) for x in (o, d, t_min, t_max)),
            *(torch.as_tensor(tr[k]) for k in TABLES)))
        for i in range(o.shape[0]):
            rec = {"case": case, "lane": int(data[f"{case}/lane"][i]),
                   "port_subpacket": [float(data[f"{case}/t"][i]), int(data[f"{case}/slot"][i])],
                   "reference_subpacket": [float(ref_t[i]), int(ref_slot[i])],
                   "port_plain_cpu": [float(plain_t[i]), int(plain_slot[i])],
                   "port_cluster": [float(data[f"{case}/cluster_t"][i]),
                                    int(data[f"{case}/cluster_slot"][i])]}
            for name in ("port_subpacket", "port_cluster"):
                s = rec[name][1]
                if s >= 0:
                    rec[name + "_f64"] = mt64(o[i], d[i], tr["tri_v0"][s], tr["tri_e1"][s],
                                              tr["tri_e2"][s])
            lanes += 1
            same_card += rec["reference_subpacket"] == rec["port_subpacket"]
            same_plain += rec["reference_subpacket"] == rec["port_plain_cpu"]
            print(json.dumps(rec))
    print(json.dumps({"lanes": lanes, "reference_equals_card_t_and_slot": same_card,
                      "reference_equals_plain_t_and_slot": same_plain}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1
         else ROOT / "tests" / "data" / "subpacket_flips_mesh_heavy.npz")
