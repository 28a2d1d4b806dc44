"""Deformation-pair datasets over the reference's on-disk directory contract.

The port's own copy of ``nsdp_tpu/data/datasets.py``, with the same RNG
contract, so the same global ``np.random`` seed gives the same items bit for
bit.  Each frame directory contains ``orig_to_gaps.txt`` (4x4 normalisation),
``surface_points.npz`` (correspondence-preserving surface samples + normals),
``flow.npz`` (space samples) and a mesh file; sequences are directories named
``<identity>_<motion>`` with zero-padded frame subdirectories.  Split ``.lst``
files list sequence names (reference ``dataset/dataset_deform4d_flow.py``).

Pair construction semantics (kept exactly):
  * non-arbitrary: canonical frame "0000" -> each frame (forward), or swapped
    via ``inverse: true`` (backward);
  * arbitrary train: all frame x frame pairs within each sequence;
  * arbitrary val/test: frame "0000" -> each later frame;
  * DeformationTransfer: each sequence is its own canonical; the source frame
    is fixed per animal ("0003" cat/lion, "0005" horse, "0001" otherwise);
  * train pair lists reshuffle (seed 100) and resample when the last index is
    fetched — stage 2 samples 36k of the ~1.6M pairs each epoch;
  * user-handle datasets (tosca/dogrec) are mesh-only; the target pose is
    synthesised by translating the configured handle region.
"""

import os
import random
from typing import Dict, List, Optional

import numpy as np

from nsdp_tpu_torch.data import transforms as T


class Deform4DFlowDataset:
    """DeformingThings4D flow pairs."""

    def __init__(
        self,
        cfg: Dict,
        iden_split: str,
        motion_split: str,
        load_mesh: bool = False,
        num_sampled_pairs: int = -1,
        rng: Optional[np.random.RandomState] = None,
    ):
        self.cfg = cfg
        self.iden_split = iden_split
        self.motion_split = motion_split
        self.load_mesh = load_mesh
        self.num_sampled_pairs = num_sampled_pairs
        self.dataset_type = cfg["data"]["type"]
        self.dataset_dir = cfg["data"]["dataset_dir"]
        self.split_dir = cfg["data"]["split_dir"]
        # Subsampling/noise RNG: a PCG64 Generator — its O(k) Floyd-style
        # choice(replace=False, shuffle=False) replaces RandomState's O(N)
        # permutation, the warm-cache assembly hot spot at stage-1 scale.
        # A legacy RandomState seeds the Generator deterministically for API
        # compatibility; the default seeds from the GLOBAL np.random stream
        # so a CLI's np.random.seed keeps controlling data randomness, as in
        # the reference.
        if rng is None:
            self.rng = np.random.default_rng(
                int(np.random.randint(0, 2**31 - 1))
            )
        elif isinstance(rng, np.random.RandomState):
            self.rng = np.random.default_rng(int(rng.randint(0, 2**31 - 1)))
        else:
            self.rng = rng
        self.is_train = motion_split[:5] == "train"

        self.all_deform_pairs: List[Dict] = []
        self.sample_deform_pairs: List[Dict] = []
        # Per-frame file cache: deform pairs share frames heavily (every
        # pair of a sequence reuses its canonical frame; stage-2 pairs all
        # frame x frame combinations), and at stage-1 scale npz parsing is
        # the input-pipeline bottleneck.  Cached
        # entries are read-only by contract: __getitem__ only slices /
        # subsamples into fresh arrays.  ``data.cache_frames`` caps the
        # entry count (~10 MB/frame at reference scale); 0 disables.
        self._frame_cache: Dict[str, Dict] = {}
        self._frame_cache_cap = int(cfg["data"].get("cache_frames", 64))
        self._load()

    # -- split / pair-list construction --------------------------------------

    def _read_split(self, split_name: str) -> List[str]:
        path = os.path.join(self.split_dir, self.dataset_type, split_name + ".lst")
        with open(path, "r") as f:
            names = [ln.strip() for ln in f.read().split("\n")]
        return [
            n
            for n in names
            if n and os.path.isdir(os.path.join(self.dataset_dir, n))
        ]

    def _frames(self, seq_name: str) -> List[str]:
        names = sorted(os.listdir(os.path.join(self.dataset_dir, seq_name)))
        interval = self.cfg["data"]["interval"]
        return [n for n in names if int(n) % interval == 0]

    def _load(self):
        iden_seqs = sorted(self._read_split(self.iden_split))
        self.models_cano_dict = {}
        for idx_cano, seq in enumerate(iden_seqs):
            iden_name = seq.split("_")[0]
            self.models_cano_dict[iden_name] = (idx_cano, seq)

        motion_seqs_raw = self._read_split(self.motion_split)
        motion_seqs = sorted(motion_seqs_raw)
        self.models_motion_dict = {
            seq: (i, seq) for i, seq in enumerate(motion_seqs)
        }

        arbitrary = self.cfg["data"]["arbitrary"]
        pairs = []
        for seq in motion_seqs_raw:
            cano_name = seq.split("_")[0]
            if seq not in self.models_motion_dict or cano_name not in self.models_cano_dict:
                continue
            idx_cano, cano_seq = self.models_cano_dict[cano_name]
            idx_motion, _ = self.models_motion_dict[seq]
            frames = self._frames(seq)
            if arbitrary:
                if self.is_train:
                    for f0 in frames:
                        for f1 in frames:
                            pairs.append(self._pair(idx_cano, cano_seq, "0000",
                                                    idx_motion, seq, f0, seq, f1))
                else:
                    for f1 in frames:
                        if int(f1) > 0:
                            pairs.append(self._pair(idx_cano, cano_seq, "0000",
                                                    idx_motion, seq, "0000", seq, f1))
            else:
                for f1 in frames:
                    pairs.append(self._pair(idx_cano, cano_seq, "0000",
                                            idx_motion, cano_seq, "0000", seq, f1))
        self.all_deform_pairs = pairs
        self._post_load()

    @staticmethod
    def _pair(idx_cano, cano_seq, cano_frame, idx_motion, src_seq, src_frame,
              tgt_seq, tgt_frame):
        return {
            "pair_info": (idx_cano, cano_seq, cano_frame,
                          idx_motion, src_seq, src_frame, tgt_seq, tgt_frame)
        }

    def _post_load(self):
        if self.is_train or self.num_sampled_pairs > 0:
            self.random_shuffle_samples(self.num_sampled_pairs)
        else:
            self.sample_deform_pairs = self.all_deform_pairs

    def random_shuffle_samples(self, num_samples: int = -1):
        random.Random(100).shuffle(self.all_deform_pairs)
        if num_samples > 0:
            self.sample_deform_pairs = self.all_deform_pairs[:num_samples]
        else:
            self.sample_deform_pairs = self.all_deform_pairs

    def __len__(self):
        return len(self.sample_deform_pairs)

    def get_metadata(self, index: int) -> Dict:
        return self.sample_deform_pairs[index]

    # -- per-frame file loading ----------------------------------------------

    def _load_data(self, data_dir: str) -> Dict:
        cached = self._frame_cache.get(data_dir)
        if cached is not None:
            return cached
        out = self._load_data_uncached(data_dir)
        if self._frame_cache_cap > 0:
            if len(self._frame_cache) >= self._frame_cache_cap:
                # FIFO eviction: cheap, and frame reuse is long-range
                # (canonical frames recur all epoch), so recency tracking
                # buys little over plain rotation
                self._frame_cache.pop(next(iter(self._frame_cache)))
            self._frame_cache[data_dir] = out
        return out

    def _load_data_uncached(self, data_dir: str) -> Dict:
        dcfg = self.cfg["data"]
        orig2world, world2orig = T.load_norm_params(
            os.path.join(data_dir, dcfg["norm_params_file"])
        )
        surf, normals = T.load_npz_surface_flow(
            os.path.join(data_dir, dcfg["surface_flow_file"])
        )
        space = T.load_npz_space_flow(
            os.path.join(data_dir, dcfg["space_flow_file"])
        )
        if dcfg["fix_coord_system"]:
            surf = T.fix_coord_system(surf)
            normals = T.fix_coord_system(normals)
            space = T.fix_coord_system(space)
        out = {
            "orig2world": orig2world,
            "world2orig": world2orig,
            "surface_samples": surf,
            "surface_normals": normals,
            "space_samples": space,
            # bbox computed once per frame (it feeds every pair sharing the
            # frame): at stage-1 scale the min/max over the full 100k-point
            # cloud was ~40% of warm-cache item assembly
            "surface_bbox": (surf.min(axis=0), surf.max(axis=0)),
        }
        if self.load_mesh:
            verts, edges, faces = T.load_mesh_info(
                os.path.join(data_dir, dcfg["mesh_file"])
            )
            if "norm" not in dcfg["mesh_file"]:
                verts = T.normalize_origin_mesh(verts, orig2world).astype(
                    np.float32
                )
            if dcfg["fix_coord_system"]:
                verts = T.fix_coord_system(verts)
            out.update(verts=verts, edges=edges, faces=faces,
                       verts_bbox=(verts.min(axis=0), verts.max(axis=0)))
        return out

    def _resolve_pair_dirs(self, index: int):
        (idx_cano, cano_seq, cano_frame, idx_motion, src_seq, src_frame,
         tgt_seq, tgt_frame) = self.sample_deform_pairs[index]["pair_info"]
        d = self.dataset_dir
        return (
            os.path.join(d, cano_seq, cano_frame),
            os.path.join(d, src_seq, src_frame),
            os.path.join(d, tgt_seq, tgt_frame),
        )

    def _maybe_reshuffle(self, index: int):
        if self.is_train and index == len(self.sample_deform_pairs) - 1:
            self.random_shuffle_samples(self.num_sampled_pairs)

    # -- item assembly -------------------------------------------------------

    def __getitem__(self, index: int) -> Dict:
        dcfg = self.cfg["data"]
        dir_cano, dir_src, dir_tgt = self._resolve_pair_dirs(index)
        self._maybe_reshuffle(index)

        data_cano = self._load_data(dir_cano)
        if not dcfg["arbitrary"] and dcfg["inverse"]:
            data_src = self._load_data(dir_tgt)
            data_tgt = self._load_data(dir_src)
        else:
            data_src = self._load_data(dir_src)
            data_tgt = self._load_data(dir_tgt)

        out: Dict = {}

        # surface flow: shared-permutation subsample preserving correspondence
        s_cano, s_src, s_tgt = (
            data_cano["surface_samples"],
            data_src["surface_samples"],
            data_tgt["surface_samples"],
        )
        bbox_min, bbox_max = data_cano["surface_bbox"]
        (s_cano, s_src, s_tgt), idxs = T.subsample_shared(
            [s_cano, s_src, s_tgt], dcfg["num_surf_samples"], rng=self.rng
        )
        (n_cano, n_src, n_tgt), _ = T.subsample_shared(
            [
                data_cano["surface_normals"],
                data_src["surface_normals"],
                data_tgt["surface_normals"],
            ],
            dcfg["num_surf_samples"],
            idxs=idxs,
        )

        handle = T.handle_mask_bbox(
            s_cano, bbox_min, bbox_max, dcfg["partial_range"]
        )
        s_tgt_masked = s_tgt * handle[:, None]
        if dcfg["noise_level"] > 0.0:
            s_src = T.add_noise(s_src, dcfg["noise_level"], rng=self.rng)
        # With ``model.use_normals`` the conditioning gains the source
        # normals: [src xyz, src normals, masked tgt xyz, mask] (10ch).
        # The reference declares the matching encoder dims
        # (``deformation_networks.py:16-30``: 3 extra backward / 7 forward
        # features) but never emits them from its dataset — this completes
        # that contract (see ``models/deformation.py`` docstring).
        parts = [s_src]
        if self.cfg.get("model", {}).get("use_normals", False):
            parts.append(n_src)
        parts += [s_tgt_masked, handle[:, None]]
        inputs = np.concatenate(parts, axis=1).astype(np.float32)

        if dcfg["partial_shape_ratio"] < 1.0:
            keep = T.partial_shape_indices(
                s_src, handle, dcfg["partial_shape_ratio"], rng=self.rng
            )
            if dcfg.get("pad_partial_shapes", False):
                # Static-shape variant: surviving rows are compacted to
                # the front and zero-padded back to num_surf_samples (padded
                # rows sit at the origin, which FPS never selects), with a
                # prefix validity mask the model uses to exclude them from
                # kNN and BatchNorm statistics — partial shapes collate at
                # any batch size.  The reference's variable-size items only
                # collate at batch 1.
                padded, valid = T.pad_partial_static(
                    keep,
                    dict(inputs=inputs, s_cano=s_cano, s_src=s_src,
                         s_tgt=s_tgt, n_cano=n_cano, n_src=n_src,
                         n_tgt=n_tgt, handle=handle),
                    min_valid=T.min_valid_points(self.cfg),
                )
                inputs = padded["inputs"]
                s_cano, s_src, s_tgt = (
                    padded["s_cano"], padded["s_src"], padded["s_tgt"]
                )
                n_cano, n_src, n_tgt = (
                    padded["n_cano"], padded["n_src"], padded["n_tgt"]
                )
                handle = padded["handle"]
                out["surface_valid_mask"] = valid
            else:
                inputs = inputs[keep]
                s_cano, s_src, s_tgt = s_cano[keep], s_src[keep], s_tgt[keep]
                n_cano, n_src, n_tgt = n_cano[keep], n_src[keep], n_tgt[keep]
                handle = handle[keep]

        out["surface_samples_cano"] = s_cano
        out["surface_samples_src"] = s_src
        out["surface_samples_tgt"] = s_tgt
        out["surface_normals_cano"] = n_cano
        out["surface_normals_src"] = n_src
        out["surface_normals_tgt"] = n_tgt
        out["cano_handle_sample_idx"] = handle[:, None].astype(np.float32)
        out["surface_samples_inputs"] = inputs

        # space flow subsample (only when more samples exist than requested)
        sp_cano, sp_src, sp_tgt = T.maybe_subsample(
            [
                data_cano["space_samples"],
                data_src["space_samples"],
                data_tgt["space_samples"],
            ],
            dcfg["num_space_samples"],
            rng=self.rng,
        )
        out["space_samples_cano"] = sp_cano
        out["space_samples_src"] = sp_src
        out["space_samples_tgt"] = sp_tgt

        if self.load_mesh:
            verts_cano = data_cano["verts"]
            verts_src = data_src["verts"]
            verts_tgt = data_tgt["verts"]
            vb_min, vb_max = data_cano["verts_bbox"]
            vhandle = T.handle_mask_bbox(
                verts_cano, vb_min, vb_max, dcfg["partial_range"]
            )
            verts_tgt_masked = verts_tgt * vhandle[:, None]
            out["verts_cano"] = verts_cano
            out["verts_src"] = verts_src
            out["verts_tgt"] = verts_tgt
            out["cano_handle_vert_idx"] = vhandle[:, None].astype(np.float32)
            out["verts_flow_inputs"] = np.concatenate(
                [verts_src, verts_tgt_masked, vhandle[:, None]], axis=1
            ).astype(np.float32)
            out["edges"] = data_cano["edges"]
            out["faces"] = data_cano["faces"]

        out["index"] = index
        return out

    @staticmethod
    def collate_fn(samples: List[Optional[Dict]]) -> Dict:
        """Stack per-sample dicts along a new batch axis (None filtered)."""
        samples = [s for s in samples if s is not None]
        out = {}
        for key in samples[0]:
            vals = [np.asarray(s[key]) for s in samples]
            out[key] = np.stack(vals, axis=0)
        return out


class DeformTransferFlowDataset(Deform4DFlowDataset):
    """DeformationTransfer sequences: per-sequence canonical + fixed source
    frames (reference ``dataset/dataset_deformtransfer_flow.py:22-122``)."""

    _SOURCE_FRAME_RULES = (("cat", "0003"), ("lion", "0003"), ("horse", "0005"))

    def _source_frame(self, seq_name: str) -> str:
        for token, frame in self._SOURCE_FRAME_RULES:
            if token in seq_name:
                return frame
        return "0001"

    def _load(self):
        motion_seqs_raw = self._read_split(self.motion_split)
        motion_seqs = sorted(motion_seqs_raw)
        self.models_motion_dict = {
            seq: (i, seq) for i, seq in enumerate(motion_seqs)
        }

        arbitrary = self.cfg["data"]["arbitrary"]
        pairs = []
        for seq in motion_seqs_raw:
            idx_motion, _ = self.models_motion_dict[seq]
            frames = self._frames(seq)
            if arbitrary:
                src_frame = self._source_frame(seq)
                for f1 in frames:
                    if int(f1) > 0:
                        pairs.append(self._pair(idx_motion, seq, "0000",
                                                idx_motion, seq, src_frame, seq, f1))
            else:
                for f1 in frames:
                    pairs.append(self._pair(idx_motion, seq, "0000",
                                            idx_motion, seq, "0000", seq, f1))
        self.all_deform_pairs = pairs
        self._post_load()


class DeformUserhandleDataset(Deform4DFlowDataset):
    """Mesh-only datasets (TOSCA / reconstructed dogs) for interactive
    handle-based editing: one pair per model, target synthesised from the
    configured user handle (reference ``dataset_userhandle_flow.py``)."""

    def _load(self):
        motion_seqs_raw = self._read_split(self.motion_split)
        motion_seqs = sorted(motion_seqs_raw)
        self.models_motion_dict = {
            seq: (i, seq) for i, seq in enumerate(motion_seqs)
        }
        pairs = []
        for seq in motion_seqs_raw:
            idx_motion, _ = self.models_motion_dict[seq]
            pairs.append(self._pair(idx_motion, seq, "0000",
                                    idx_motion, seq, "0000", seq, "0000"))
        self.all_deform_pairs = pairs
        self._post_load()

    def _load_data_uncached(self, data_dir: str) -> Dict:
        dcfg = self.cfg["data"]
        orig2world, world2orig = T.load_norm_params(
            os.path.join(data_dir, dcfg["norm_params_file"])
        )
        out = {"orig2world": orig2world, "world2orig": world2orig}
        if self.load_mesh:
            verts, edges, faces = T.load_mesh_info(
                os.path.join(data_dir, dcfg["mesh_file"])
            )
            if "norm" not in dcfg["mesh_file"]:
                verts = T.normalize_origin_mesh(verts, orig2world).astype(
                    np.float32
                )
            if dcfg["fix_coord_system"]:
                verts = T.fix_coord_system(verts)
            out.update(verts=verts, edges=edges, faces=faces)
        return out

    def __getitem__(self, index: int) -> Dict:
        dcfg = self.cfg["data"]
        if self.cfg.get("model", {}).get("use_normals", False):
            raise ValueError(
                "use_normals is not supported for user-handle datasets: "
                "they are mesh-only (vertices double as surface samples, no "
                "stored normals); the reference has no working normals path "
                "here either."
            )
        dir_cano, dir_src, dir_tgt = self._resolve_pair_dirs(index)
        self._maybe_reshuffle(index)

        data_cano = self._load_data(dir_cano)
        data_src = self._load_data(dir_src)

        out: Dict = {}
        s_cano = data_cano["verts"]
        s_src = data_src["verts"]
        bbox_min, bbox_max = s_cano.min(axis=0), s_cano.max(axis=0)
        handle, s_tgt = T.user_defined_handles(
            dcfg["userhandle"], s_cano, bbox_min, bbox_max, s_src,
            dcfg["partial_range"],
        )
        s_tgt_masked = s_tgt * handle[:, None]
        if dcfg["noise_level"] > 0.0:
            s_src = T.add_noise(s_src, dcfg["noise_level"], rng=self.rng)
        inputs = np.concatenate(
            [s_src, s_tgt_masked, handle[:, None]], axis=1
        ).astype(np.float32)

        if dcfg["partial_shape_ratio"] < 1.0:
            keep = T.partial_shape_indices(
                s_src, handle, dcfg["partial_shape_ratio"], rng=self.rng
            )
            if dcfg.get("pad_partial_shapes", False):
                # static-shape variant, see Deform4DFlowDataset.__getitem__
                padded, valid = T.pad_partial_static(
                    keep,
                    dict(inputs=inputs, s_cano=s_cano, s_src=s_src,
                         s_tgt=s_tgt, handle=handle),
                    min_valid=T.min_valid_points(self.cfg),
                )
                inputs = padded["inputs"]
                s_cano, s_src, s_tgt = (
                    padded["s_cano"], padded["s_src"], padded["s_tgt"]
                )
                handle = padded["handle"]
                out["surface_valid_mask"] = valid
            else:
                inputs = inputs[keep]
                s_cano, s_src, s_tgt = s_cano[keep], s_src[keep], s_tgt[keep]
                handle = handle[keep]

        out["surface_samples_cano"] = s_cano
        out["surface_samples_src"] = s_src
        out["surface_samples_tgt"] = s_tgt
        out["cano_handle_sample_idx"] = handle[:, None].astype(np.float32)
        out["surface_samples_inputs"] = inputs

        if self.load_mesh:
            verts_cano = data_cano["verts"]
            verts_src = data_src["verts"]
            vb_min, vb_max = verts_cano.min(axis=0), verts_cano.max(axis=0)
            vhandle, verts_tgt = T.user_defined_handles(
                dcfg["userhandle"], verts_cano, vb_min, vb_max, verts_src,
                dcfg["partial_range"],
            )
            out["verts_cano"] = verts_cano
            out["verts_src"] = verts_src
            out["verts_tgt"] = verts_tgt
            out["cano_handle_vert_idx"] = vhandle[:, None].astype(np.float32)
            out["verts_flow_inputs"] = np.concatenate(
                [verts_src, verts_tgt * vhandle[:, None], vhandle[:, None]],
                axis=1,
            ).astype(np.float32)
            out["edges"] = data_cano["edges"]
            out["faces"] = data_cano["faces"]

        out["index"] = index
        return out
