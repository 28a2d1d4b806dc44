"""Dense evaluation: ``DeformationService.deform``, numpy in and out, one
client in a closed loop over a pool of seeded requests.

Correctness: a sample of the pool's requests is drawn from the seed
(``check_requests`` of them), and every answer the window gave to one of
them is held against the reference's evaluation of the request's own
inputs in float64, worked out once for each, beside the reference's in
float32.  The model amplifies rounding: in the deforming half the FPS and
kNN selections run on coordinates computed in the canonicalising half,
where a near-tie falls either way, and on some seeds' weights some answers
move by 1e-2 to 1 with the rounding alone, the reference's float32 against
its own float64 as much as the program's (``PERF.md``).  So each answer's error against
float64 is read as a multiple of the float32 reference's error on the same
request, and the median and the 75th percentile of the multiples over
those answers are compared: about 1 for answers as exact as float32
arithmetic allows, hundreds under the lower-precision control, and high
in the percentile where a fault spares some calls, such as a stale buffer
read on every other call (the fault ``answer_alternate``).
"""

from typing import Dict, List

import numpy as np
import torch

from nsdp_bench.entries import common
from nsdp_bench.traffic import generate


class Cell(common.Cell):
    def setup(self, state):
        from nsdp_tpu_torch.serving import DeformationService

        self.pool = generate.requests(self.traffic, self.seed)
        self.svc = DeformationService({"model": self.cfg["model"]}, state_dict=state,
                                      device=self.device)
        self.programs = self.make_programs([None if self.svc.graphs is None
                                            else self.svc.graphs[0]])
        r = self.pool[0]
        self.programs.call(lambda: self.svc.deform(r["points"], r["inputs"]))
        self.answers: List = []

    def unit(self, i: int) -> int:
        k = i % len(self.pool)
        r = self.pool[k]
        with self.spans("deform"):
            t0 = self.clock()
            out = self.svc.deform(r["points"], r["inputs"])
            self.calls.append((self.clock() - t0, self.spans.on, "deform"))
        if self.fault in ("answer", "answer_alternate"):
            stale = self.stale(out)
            if self.fault == "answer" or i % 2:
                out = stale
        self.answers.append((k, out))
        return 1

    def e2e(self, window) -> Dict[str, float]:
        points = sum(len(self.pool[k]["points"]) for k, _ in self.answers)
        return {"query_points_per_s": points / window.seconds,
                "latency_ms_p95": common.p95_ms([c[0] for c in self.calls])}

    def failed(self) -> int:
        return sum(not np.isfinite(a).all() for _, a in self.answers)

    def release(self):
        del self.svc, self.programs
        self.flush()

    def work(self) -> Dict[str, float]:
        from nsdp_bench import counts

        q = len(self.pool[0]["points"])
        ev = counts.evaluation(self.cfg["model"], self.traffic["surface_points"], q)
        return {"flops": ev["flops"], "k1_least_ms": counts.k1_least_ms(ev["sites"])}

    def readings(self, ref) -> Dict[str, float]:
        ref64 = common.float64(ref)
        asked = sorted({k for k, _ in self.answers})
        chosen = sorted(generate.rng_for(self.seed, 4).choice(
            asked, min(self.traffic["check_requests"], len(asked)), replace=False).tolist())
        answers = [(k, out) for k, out in self.answers if k in chosen]
        want = {}  # pool index -> (float64 answer, the float32 reference's error against it)
        for k in chosen:
            pts, inp = (self.to_device(self.pool[k][key])[None] for key in ("points", "inputs"))
            with torch.no_grad():
                want32 = ref.predict(pts, inp)[0].cpu().numpy()
                want64 = ref64.predict(pts.double(), inp.double())[0].cpu()
            want[k] = (want64, max(common.rel_l2(want32, want64), common.FLOOR))
        errs = np.array([common.rel_l2(out, want[k][0]) for k, out in answers])
        ratios = errs / np.array([want[k][1] for k, _ in answers])
        self.log(f"serve: {len(answers)} of {len(self.answers)} answers judged, those to"
                 f" {len(want)} of the pool's requests; the float32 "
                 "reference's errors against float64 " + " ".join(
                     f"{want[k][1]:.3g}" for k in sorted(want)) + "; the answers' multiples of"
                 " them, quantiles 0/25/50/75/90/100% " + " ".join(
                     f"{q:.3g}" for q in np.percentile(ratios, [0, 25, 50, 75, 90, 100])))
        return {"err_ratio_median": float(np.median(ratios)),
                "err_ratio_q75": float(np.percentile(ratios, 75)),
                "err_median": float(np.median(errs))}
