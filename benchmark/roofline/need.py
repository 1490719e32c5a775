"""The work a cell's paths need, per camera path, counted on the plain
reference (benchmark/reference/tracer.py) over a fixed sample of them.

Need.observe sees each search of the reference's lockstep loop and
Need.on_bounce its masks: a closest-hit ray is needed on a live lane, a
shadow ray on a live hit. Per needed ray it adds the Möller-Trumbore
operations over the scene's triangles (kernels B1 and B3 search them all)
and, where KD cells are given, over the members of every cell whose entry
lies before the ray's hit, plus one slab test per cell (kernel B2's walk).
"""

from __future__ import annotations

import torch

from benchmark import roofline
from benchmark.roofline.kd import Cells, slab


class Need:
    def __init__(self, table, cells: Cells = None):
        self.table = table
        self.cells = cells
        self.pending = {}
        z = lambda: torch.zeros((), dtype=torch.float64, device=table.device)
        self.mt_ops, self.kd_ops = z(), z()
        self.closest, self.shadow, self.hits, self.visible = z(), z(), z(), z()

    def observe(self, kind, org, dirn, t_min, t_max, hit, best_t):
        ops = roofline.mt_pair_ops(self.table, org, dirn)
        kd = self._kd_ops(org, dirn, t_min, torch.where(hit, best_t, t_max)) if self.cells else None
        self.pending[kind] = (ops, kd)

    def _kd_ops(self, org, dirn, t_min, reach):
        c = self.cells
        cross, tnear = slab(org, dirn, c.bmin, c.bmax, t_min, reach)
        need = cross & (tnear <= torch.maximum(reach, reach * 1.00000024)[:, None])
        ops = torch.full((org.shape[0],), float(c.num_cells * roofline.SLAB_OPS),
                         dtype=torch.float64, device=org.device)
        for m in range(c.num_cells):
            rows = torch.nonzero(need[:, m]).flatten()
            if rows.numel():
                ops.index_add_(0, rows, roofline.mt_pair_ops(c.members[m], org[rows], dirn[rows]))
        return ops

    def on_bounce(self, info):
        alive, live_hit, reached = info["alive"], info["live_hit"], info["reached"]
        masks = {"closest": alive, "shadow": live_hit}
        for kind, (ops, kd) in self.pending.items():
            m = masks[kind]
            self.mt_ops += torch.where(m, ops, 0.0).sum()
            if kd is not None:
                self.kd_ops += torch.where(m, kd, 0.0).sum()
        self.closest += alive.sum()
        self.hits += live_hit.sum()
        if reached is not None:
            self.shadow += live_hit.sum()
            self.visible += (live_hit & reached).sum()
        self.pending.clear()

    def per_path(self, paths: int, num_spheres: int) -> dict:
        """Operations and rays per camera path of the sample."""
        n = lambda x: float(x) / paths
        rays = n(self.closest) + n(self.shadow)
        return {
            "rays": rays,
            "closest_rays": n(self.closest),
            "shadow_rays": n(self.shadow),
            "b1_ops": (n(self.mt_ops) + rays * num_spheres * roofline.SPHERE_OPS
                       + n(self.hits) * roofline.SHADE_OPS
                       + n(self.visible) * roofline.NEE_VISIBLE_OPS),
            "b3_ops": n(self.mt_ops),
            "b2_ops": n(self.kd_ops),
        }
