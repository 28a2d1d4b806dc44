"""Deformation-field serving: numpy in, numpy out, bucketed query sizes.

Counterpart of ``nsdp_tpu/serving.py`` on PyTorch/CUDA:

    service = DeformationService.from_config("configs/deform4d/arbitrary.yaml")
    deformed = service.deform(points, surface_samples_inputs)      # numpy
    session = service.edit_session(points, surface_src)            # once
    dragged = session.drag(surface_tgt_masked, handle_mask)        # per drag

Queries are zero-padded to a ladder of bucket sizes (exact: field queries
are independent), so the card sees few distinct shapes.  The model runs
under ``torch.inference_mode``; every kNN attention and FPS of the path is a
hand-written CUDA kernel on the card.

On the card every entry runs as a captured CUDA graph per bucket
(``graphs.Graphs``; the counterpart of the JAX service's compiled programs,
``nsdp_tpu/serving.py:133-189,355-356``): ``deform`` with and without a
``point_mask``, the edit session's canonicalisation half and its drag
(forward) half, each captured at the first request of its shape -- or all
at once by :meth:`DeformationService.warmup` -- and replayed after.
``graphs=False`` runs them eagerly, op by op.

``devices=(...)`` splits the query axis over several devices of one process
(the counterpart of a ``('data', 'query')`` mesh with ``data=1``,
``nsdp_tpu/serving.py:25-35,129-131,338-352``): one replica of the model
per device encodes the surface and decodes its share of the queries; the
shares are concatenated in order.  Each replica captures its own programs
on its own device.
"""

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from nsdp_tpu_torch import resolve_device
from nsdp_tpu_torch.graphs import Graphs
from nsdp_tpu_torch.models import build_model, evaluation_config, init_random
from nsdp_tpu_torch.training.checkpoints import read_state_dict
from nsdp_tpu_torch.utils.padding import pad_queries
from nsdp_tpu_torch.utils.profiling import count, span

WARM_SURFACE_POINTS = 256  # the surface size the JAX service warms at


def _host(t: torch.Tensor) -> np.ndarray:
    """A float32 host copy the caller owns (never a view of a program's
    static output, which the next call overwrites -- ``.cpu()`` of a CPU
    tensor copies nothing).  The copy from the card blocks the host until
    the card has finished the work queued before it, and then until the
    copy is done: the span ``serve.wait``.  (A synchronise of the stream
    before the copy, to time the two apart, slowed a request by 0.3-0.6 ms
    at the median and more in the tail on the H100: ``PERF.md``.)"""
    with span("serve.wait"):
        t = t.to("cpu", torch.float32, copy=True)
    return t.numpy()


class DeformationService:
    """Stateful server around one deformation model.

    Args:
      config: the YAML config (``utils.config.load_config``).
      state_dict: the model's weights (e.g. ``utils.convert.from_jax_variables``).
      weight_file: a model file (the reference's torch format or a raw state
        dict, ``training.checkpoints.read_state_dict``) to load instead; a
        missing file raises ``FileNotFoundError``.  With neither
        ``state_dict`` nor ``weight_file`` the weights are seeded random
        (``models.init_random``).
      buckets: query-count ladder requests are padded to (each rounded up
        to a multiple of the number of devices).
      device: ``cuda`` by default; ``cpu`` runs the plain PyTorch path.
      seed: seed of the random weights.
      devices: several devices to split every request's queries over, one
        replica of the model each (``self.model`` is the first); instead of
        ``device``.
      warm: run :meth:`warmup` at construction, at 256 surface points (the
        JAX service's warm size, ``nsdp_tpu/serving.py:55,108-109``).
      graphs: run every entry as a captured CUDA graph per replica and
        input shape (module docstring), the counterpart of the JAX
        service's compiled programs as ``use_fused`` is of its fused path.
        None (the default): on for a service on the card, off on the CPU;
        False: eager, op by op (the A/B against the captured path); True
        on the CPU keeps the captured path's static-buffer contract
        (``graphs.Program``), for the tests.

    The model is built from ``models.evaluation_config(config)``: the
    shipped pair evaluates in float32 under any ``model.compute_dtype``, as
    the JAX service's fused path does; an ablation pair in the config's
    dtype.  Results are float32 numpy either way.
    """

    def __init__(self, config: Dict, state_dict: Optional[Dict] = None,
                 buckets: Sequence[int] = (4096, 16384, 65536), device=None,
                 seed: int = 0, weight_file: Optional[str] = None,
                 devices: Optional[Sequence] = None, warm: bool = False,
                 graphs: Optional[bool] = None):
        if state_dict is not None and weight_file is not None:
            raise ValueError("pass state_dict or weight_file, not both")
        if devices is not None and device is not None:
            raise ValueError("pass device or devices, not both")
        if weight_file is not None:
            state_dict = read_state_dict(weight_file)
        self.devices = [resolve_device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        self.config = config
        self.buckets = sorted(buckets)
        self.model_type = config["model"]["type"]
        self.model = build_model(evaluation_config(config), device=self.device)
        if state_dict is None:
            init_random(self.model, seed)
        else:
            self.model.load_state_dict(state_dict, strict=True)
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d)
                                        for d in self.devices[1:]]
        if graphs is None:
            graphs = all(d.type == "cuda" for d in self.devices)
        # each replica's captured programs, or None: eager
        self.graphs = [Graphs(d) for d in self.devices] if graphs else None
        if warm:
            self.warmup(WARM_SURFACE_POINTS)

    @classmethod
    def from_config(cls, config_path: str, **kwargs) -> "DeformationService":
        """Service for a YAML config, with the weights of its
        ``test.weight_file`` (as ``nsdp_tpu/serving.py`` loads them; a missing
        file raises ``FileNotFoundError``).  ``state_dict=...`` serves given
        weights instead, ``weight_file=None`` seeded random ones."""
        from nsdp_tpu_torch.utils.config import load_config

        config = load_config(config_path)
        if "state_dict" not in kwargs:
            kwargs.setdefault("weight_file", config.get("test", {}).get("weight_file"))
        return cls(config, **kwargs)

    def _bucket(self, q: int) -> int:
        out = next((b for b in self.buckets if q <= b), None)
        if out is None:  # round up to a multiple of the largest bucket
            big = self.buckets[-1]
            out = ((q + big - 1) // big) * big
        m = len(self.devices)  # every device takes an equal share
        return ((out + m - 1) // m) * m

    def _tensor(self, a, device=None) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(device or self.device)
        return torch.as_tensor(np.asarray(a, np.float32), device=device or self.device)

    def _call(self, i: int, name: str, fn, *args):
        """Replica ``i``'s ``fn`` on ``args`` (arrays, tensors or None):
        eagerly on its device, or through its captured program for
        ``name`` at the arguments' shapes, which copies each argument into
        its static buffer from where it lies."""
        if self.graphs is None:
            return fn(*(None if a is None else self._tensor(a, self.devices[i]) for a in args))
        host = lambda a: a if a is None or isinstance(a, torch.Tensor) else self._tensor(a, "cpu")
        return self.graphs[i](name, fn, *map(host, args))

    def _shares(self, padded: np.ndarray) -> List[np.ndarray]:
        """The (B, Q, 3) padded queries cut into one equal share per device."""
        return np.split(padded, len(self.devices), axis=1)

    def _joined(self, outs: List[torch.Tensor]) -> torch.Tensor:
        """The replicas' (B, share, 3) outputs joined in order along the
        queries, on the first device."""
        return outs[0] if len(outs) == 1 else torch.cat([o.to(self.device) for o in outs], dim=1)

    def warmup(self, n_surface: int) -> None:
        """Run every serving entry once at every bucket size, for
        ``n_surface`` conditioning points -- ``deform`` with and without a
        ``point_mask`` and, for the 'arbitrary' composition, an edit
        session and a drag.  On the card it captures each of them as a
        CUDA graph per replica (the counterpart of the JAX service's
        ``warmup``, ``nsdp_tpu/serving.py:133-189``, which compiles every
        bucket ahead of the first request); eagerly it builds the kernels
        and fills PyTorch's allocator cache."""
        rng = np.random.RandomState(0)
        inputs = rng.randn(n_surface, 7).astype(np.float32)
        pmask = np.ones((n_surface,), np.float32)
        for b in self.buckets:
            pts = rng.randn(b, 3).astype(np.float32)
            for pm in (None, pmask):
                self.deform(pts, inputs, point_mask=pm)
                if self.model_type == "arbitrary":
                    self.edit_session(pts, inputs[:, 0:3], pm).drag(
                        inputs[:, 3:6], inputs[:, 6:7]
                    )

    def deform(self, points: np.ndarray, surface_samples_inputs: np.ndarray,
               point_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Evaluate the deformation field.

        Args:
          points: (Q, 3) or (B, Q, 3) query positions.
          surface_samples_inputs: (N, 7) or (B, N, 7) conditioning.
          point_mask: optional (N,) or (B, N) validity mask of padded partial
            conditioning clouds (padded rows zero, nonzero = real point).

        Returns:
          deformed positions, same leading shape as ``points``.
        """
        with span("serve.deform"):
            with span("serve.pad"):
                squeeze = points.ndim == 2
                if squeeze:
                    points = points[None]
                    surface_samples_inputs = surface_samples_inputs[None]
                    if point_mask is not None:
                        point_mask = np.asarray(point_mask)[None]
                b, q = points.shape[:2]
                padded, _ = pad_queries(np.asarray(points), self._bucket(q))
                shares = self._shares(padded)
            count("serve.rows_valid", b * q)
            count("serve.rows_padded", b * padded.shape[1])
            with torch.inference_mode():
                # every replica's work is queued before the first result is read
                outs = [self._call(i, "deform", model.predict, share, surface_samples_inputs,
                                   point_mask)
                        for i, (model, share) in enumerate(zip(self.replicas, shares))]
                with span("serve.fetch"):
                    out = _host(self._joined(outs)[:, :q])
            return out[0] if squeeze else out

    def edit_session(self, points: np.ndarray, surface_samples_src: np.ndarray,
                     point_mask: Optional[np.ndarray] = None) -> "EditSession":
        """Open an interactive editing session over a fixed source shape.

        The canonicalisation half (backward net: encode the source surface,
        canonicalise the query points and the surface) depends only on the
        source, so it runs once here; each drag re-runs only the forward
        half (the reference re-runs all three passes,
        ``model/flow_arbitrary.py:15-27``).

        Args:
          points: (Q, 3) query positions deformed at every drag.
          surface_samples_src: (N, 3) source surface samples.
          point_mask: optional (N,) validity mask for padded-partial
            conditioning.
        """
        if self.model_type != "arbitrary":
            raise ValueError(
                f"edit sessions need the 'arbitrary' composition (got {self.model_type!r})"
            )
        with span("serve.open"):
            with span("serve.pad"):
                q = points.shape[0]
                padded, _ = pad_queries(np.asarray(points)[None], self._bucket(q))
                src = np.asarray(surface_samples_src, np.float32)[None]
                queries = self._shares(padded)
            count("serve.rows_valid", q)
            count("serve.rows_padded", padded.shape[1])
            shares = []
            with torch.inference_mode():
                for i, (model, d, share) in enumerate(zip(self.replicas, self.devices, queries)):
                    pm = None if point_mask is None else self._tensor(point_mask, d).reshape(1, -1)
                    space_cano, surf_cano = self._call(i, "canonicalize", model.canonicalize,
                                                       share, src, pm)
                    if self.graphs is not None:
                        # the session owns its canonical pose: the program's
                        # outputs are overwritten by the next call (another
                        # session's at the same bucket)
                        with span("serve.fetch"):
                            space_cano, surf_cano = space_cano.clone(), surf_cano.clone()
                    shares.append((space_cano, surf_cano, pm))
            return EditSession(self, shares, q)


class EditSession:
    """Precomputed canonicalisation + per-drag forward evaluation, per
    device: its share of the canonicalised queries, the canonicalised
    surface and the point mask, owned by the session (on the card each
    drag copies them into the drag program's static inputs)."""

    def __init__(self, service: DeformationService, shares, q: int):
        self._service = service
        self._shares = shares
        self._q = q

    def drag(self, surface_samples_tgt: np.ndarray, handle_mask: np.ndarray) -> np.ndarray:
        """Deform the session's query points toward a (partial) target.

        Args:
          surface_samples_tgt: (N, 3) masked target positions (zeros outside
            the handle, like ``surface_samples_inputs[:, 3:6]``).
          handle_mask: (N, 1) or (N,) handle indicator.

        Returns:
          (Q, 3) deformed query positions.
        """
        svc = self._service
        with span("serve.drag"):
            with span("serve.pad"):
                tgt = np.asarray(surface_samples_tgt, np.float32)[None]
                mask = np.asarray(handle_mask, np.float32).reshape(1, -1, 1)
            count("serve.rows_valid", self._q)
            count("serve.rows_padded", sum(space.shape[1] for space, _, _ in self._shares))
            with torch.inference_mode():
                outs = [svc._call(i, "drag", model.deform, space_cano, surf_cano, tgt, mask, pm)
                        for i, (model, (space_cano, surf_cano, pm))
                        in enumerate(zip(svc.replicas, self._shares))]
                with span("serve.fetch"):
                    return _host(svc._joined(outs)[0, : self._q])
