"""Interactive handle editing: ``DeformationService.edit_session`` (the
canonicalisation, once a session) and ``EditSession.drag`` (the forward
half), numpy in and out, one client in a closed loop over a pool of
seeded sessions.

Correctness, in two stages as the program runs them.  The session's
canonical pose (its state, which the drags read) is held against the
reference's canonicalisation of the session's own inputs; then each
sampled drag against the reference's forward half run on that same
canonical pose, so that the reference's FPS and kNN select on the
coordinates the program's did.  Both stages' selections see identical
coordinates on both sides.  The canonical pose's largest gap is compared;
the drags' median gap, since the forward half amplifies rounding in a
few sessions to ~1e-2 (``PERF.md``).
"""

from typing import Dict, List

import numpy as np
import torch

from nsdp_bench.entries import common
from nsdp_bench.traffic import generate


class Cell(common.Cell):
    def setup(self, state):
        from nsdp_tpu_torch.serving import DeformationService

        self.pool = generate.sessions(self.traffic, self.seed)
        self.svc = DeformationService({"model": self.cfg["model"]}, state_dict=state,
                                      device=self.device)
        self.programs = self.make_programs([None if self.svc.graphs is None
                                            else self.svc.graphs[0]])
        by_q = sorted(self.pool, key=lambda s: len(s["points"]))
        for s in (by_q[0], by_q[-1]):  # the smallest and largest queries: both buckets
            session = self.programs.call(lambda: self.svc.edit_session(s["points"], s["surface"]))
            self.programs.call(lambda: session.drag(s["targets"][0], s["mask"]))
        self.opened: List = []  # (pool index, session, [drag outputs])
        self.rows = {"valid": 0, "padded": 0}

    def _timed(self, name, fn, q):
        before = self.programs.calls()
        with self.spans(name):
            t0 = self.clock()
            out = fn()
            t1 = self.clock()
        shape = self.programs.shape_of(before)
        self.calls.append((t1 - t0, self.spans.on, (name, None if shape is None else shape[1])))
        if shape is not None:
            self.rows["valid"] += q
            self.rows["padded"] += shape[1]
        return out

    def unit(self, i: int) -> int:
        k = i % len(self.pool)
        s = self.pool[k]
        q = len(s["points"])
        session = self._timed("open", lambda: self.svc.edit_session(s["points"], s["surface"]), q)
        outs = []
        for tgt in s["targets"]:
            out = self._timed("drag", lambda: session.drag(tgt, s["mask"]), q)
            outs.append(self.stale(out) if self.fault == "answer" else out)
        self.opened.append((k, session, outs))
        return 1 + len(outs)

    def e2e(self, window) -> Dict[str, float]:
        return {"latency_ms_p95": common.p95_ms([c[0] for c in self.calls])}

    def failed(self) -> int:
        return sum(not np.isfinite(o).all() for _, _, outs in self.opened for o in outs)

    def counters(self) -> Dict[str, float]:
        return dict(self.rows)

    def release(self):
        rng = generate.rng_for(self.seed, 4)
        n = min(self.traffic["check_sessions"], len(self.opened))
        self.checked = []
        for j in rng.choice(len(self.opened), n, replace=False):
            k, session, outs = self.opened[j]
            (space, surf, _), = session._shares  # the session's canonical pose
            q = len(self.pool[k]["points"])
            drags = rng.choice(len(outs), min(self.traffic["check_drags"], len(outs)),
                               replace=False)
            self.checked.append((k, space[:, :q].detach().cpu(), surf.detach().cpu(),
                                 [(int(d), outs[d]) for d in drags]))
        del self.svc, self.programs, self.opened
        self.flush()

    def readings(self, ref) -> Dict[str, float]:
        cano, drag = [], []
        for k, space, surf, drags in self.checked:
            s = self.pool[k]
            with torch.no_grad():
                want_space, want_surf = ref.canonicalize(self.to_device(s["points"])[None],
                                                         self.to_device(s["surface"])[None])
                cano += [common.rel_l2(space, want_space), common.rel_l2(surf, want_surf)]
                for d, out in drags:
                    want = ref.deform(space.to(self.device), surf.to(self.device),
                                      self.to_device(s["targets"][d])[None],
                                      self.to_device(s["mask"])[None])[0]
                    drag.append(common.rel_l2(out, want))
        self.log(f"drag: sessions judged {len(self.checked)}; canonical pose errors "
                 + " ".join(f"{e:.3g}" for e in sorted(cano)) + "; drag errors "
                 + " ".join(f"{e:.3g}" for e in sorted(drag)))
        return {"cano_gap": float(max(cano)), "drag_gap": float(np.median(drag)),
                "drag_gap_max": float(max(drag))}
