"""LinnaeusInferenceHandler on one CUDA (or CPU) device.

Port of linnaeus_tpu/inference/handler.py. :meth:`load_from_artifacts`
assembles a bundle from disk: its config.yaml (relative paths resolve
against the bundle's directory), the taxonomy tree and class maps, and the
model built from the config (the architecture variant file merged, the tree
handed to hierarchical heads) with its weights (a Flax ``.msgpack`` or a
torch state_dict). ``predict`` brings images to uint8 NHWC and metadata to
the packed aux vector on the host, pads the batch to a power-of-two bucket,
and runs one forward per chunk of at most ``batch_size`` images: uint8 ->
/255 -> mean/std on the device, the model, a float32 softmax and per-task
top-k, all packed into one (B, 2 * n_tasks, k) float32 tensor that is
fetched with one copy to the host. At most two chunks are in flight.
Results are ``HierarchicalClassificationResult``s.

With ``enable_hierarchical_consistency_check`` on (the default) every
result goes through :func:`enforce_hierarchical_consistency` against the
taxonomy tree the handler was given. ``data_parallel`` 1, "1", "off", False
or None is one device, and "auto" resolves to one: this handler serves on
one device; several devices raise (not ported yet, M10).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from .artifacts import (
    ClassIndexMapData,
    TaxonomyData,
    load_class_index_maps_artifact,
    load_taxonomy_tree_artifact,
    rank_level_from_task_key,
)
from .config import InferenceConfig, load_inference_config
from .model_utils import load_model_for_inference
from .postprocessing import enforce_hierarchical_consistency
from .preprocessing import preprocess_image_batch, preprocess_metadata_batch
from .schemas import (
    HierarchicalClassificationResult,
    InferenceRequestMetadata,
    ModelInformation,
    TaskPrediction,
)

# at most this many dispatched-but-unfetched chunks live on the device
_MAX_INFLIGHT_CHUNKS = 2

RequestOptions = InferenceRequestMetadata | list[InferenceRequestMetadata | None] | None


def _resolve_data_parallel(spec) -> int:
    """1, "1", "off", False, None and "auto" -> one device; anything else
    asks for data-parallel serving, which this handler does not do."""
    if spec in (1, "1", "off", False, None, "auto"):
        return 1
    raise NotImplementedError(f"data_parallel={spec!r}: this handler serves on one device")


class LinnaeusInferenceHandler:
    """``taxonomy_data`` may be None only with
    ``inference_options.enable_hierarchical_consistency_check`` off."""

    def __init__(self, config: InferenceConfig, model: nn.Module,
                 taxonomy_data: TaxonomyData | None, class_maps: ClassIndexMapData):
        opts = config.inference_options
        self._dp = _resolve_data_parallel(opts.data_parallel)
        if opts.enable_hierarchical_consistency_check and taxonomy_data is None:
            raise ValueError(
                "enable_hierarchical_consistency_check is on but taxonomy_data is None: "
                "pass the taxonomy tree (inference.artifacts.load_taxonomy_tree_artifact) "
                "or set the option to false"
            )
        self.taxonomy = taxonomy_data
        self.config = config
        self.model = model.eval()
        self.class_maps = class_maps
        self.task_keys = list(config.model.model_task_keys_ordered)
        self._n_classes = [int(n) for n in config.model.num_classes_per_task]
        self._max_batch = int(opts.batch_size)
        self.device = next(model.parameters()).device
        pre = config.input_preprocessing
        self._mean = torch.tensor(pre.image_mean, device=self.device).view(1, 1, 1, -1)
        self._std = torch.tensor(pre.image_std, device=self.device).view(1, 1, 1, -1)

    @classmethod
    def load_from_artifacts(cls, config_path: str | Path,
                            artifacts_dir: str | Path | None = None) -> "LinnaeusInferenceHandler":
        """The handler of a bundle on disk. Relative paths in the config
        (taxonomy tree, class map, weights) resolve against ``artifacts_dir``,
        by default the config's directory; the architecture variant path goes
        to the config loader as given (absolute, or under ``$CONFIG_DIR``),
        as in the JAX package. The model lands on
        ``inference_options.device``."""
        config = load_inference_config(config_path)
        base = Path(artifacts_dir) if artifacts_dir else Path(config_path).parent

        def resolve(p: str) -> str:
            path = Path(p)
            return str(path if path.is_absolute() else base / path)

        tax = config.taxonomy_data
        taxonomy = load_taxonomy_tree_artifact(
            resolve(tax.taxonomy_tree_path), tax.source_name, tax.version, tax.root_identifier)
        m = config.model
        class_maps = load_class_index_maps_artifact(
            resolve(tax.class_index_map_path), m.model_task_keys_ordered,
            m.num_classes_per_task, m.null_class_indices)
        if not m.weights_path.startswith("hf://") and not Path(m.weights_path).is_absolute():
            m.weights_path = resolve(m.weights_path)
        model = load_model_for_inference(config, taxonomy_tree=taxonomy.taxonomy_tree)
        return cls(config, model, taxonomy, class_maps)

    @torch.inference_mode()
    def _forward(self, images_u8: torch.Tensor, aux: torch.Tensor, k: int) -> torch.Tensor:
        """uint8 (B, H, W, C) and aux (B, A) on the device -> packed
        (B, 2 * n_tasks, k) float32: per task its top-k probabilities, then
        their class indices; tasks with fewer than k classes pad with -1.0
        and index 0."""
        x = (images_u8.float() / 255.0 - self._mean) / self._std
        outputs = self.model(x, aux)
        packed = []
        for task, n_t in zip(self.task_keys, self._n_classes):
            p = torch.softmax(outputs[task].float(), dim=-1)
            k_t = min(k, n_t)
            vals, idx = torch.topk(p, k_t, dim=-1)
            if k_t < k:
                vals = nn.functional.pad(vals, (0, k - k_t), value=-1.0)
                idx = nn.functional.pad(idx, (0, k - k_t), value=0)
            packed += [vals, idx.float()]
        return torch.stack(packed, dim=1)

    def _bucket(self, n: int) -> int:
        """Smallest power of two >= n, capped at the batch size."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self._max_batch)

    def warmup(self) -> int:
        """Run one forward per batch bucket at the default top-k (builds the
        kernels and any lazily initialised library state before traffic);
        returns the number of buckets run."""
        c, h, w = self.config.input_preprocessing.image_size
        aux_dim = self.config.aux_vector_length()
        k = self.config.inference_options.default_top_k
        buckets = sorted({self._bucket(n) for n in range(1, self._max_batch + 1)})
        for b in buckets:
            self._forward(
                torch.zeros((b, h, w, c), dtype=torch.uint8, device=self.device),
                torch.zeros((b, aux_dim), device=self.device), int(k),
            ).cpu()
        return len(buckets)

    # ------------------------------------------------------------------ predict
    def predict(self, images: list[Any], metadata: list[dict[str, Any] | None] | None = None,
                request_options: RequestOptions = None) -> list[HierarchicalClassificationResult]:
        return self.predict_async(images, metadata, request_options)()

    def predict_async(
        self, images: list[Any], metadata: list[dict[str, Any] | None] | None = None,
        request_options: RequestOptions = None,
    ) -> Callable[[], list[HierarchicalClassificationResult]]:
        """Preprocess and dispatch the forward(s); return a finisher that
        fetches the results and builds them. ``request_options`` is one
        InferenceRequestMetadata for every sample or a per-sample list."""
        default_k = self.config.inference_options.default_top_k
        if isinstance(request_options, list):
            per_sample = list(request_options)
            if len(per_sample) != len(images):
                raise ValueError(
                    f"request_options list length {len(per_sample)} != "
                    f"number of images {len(images)}"
                )
        else:
            per_sample = [request_options] * len(images)

        bs = self._max_batch
        completed: list[tuple[np.ndarray, list, int]] = []
        dispatched: list[tuple[torch.Tensor, int, list, int]] = []

        def drain_oldest():
            out, n, opts, k = dispatched.pop(0)
            completed.append((out[:n].cpu().numpy(), opts, k))  # one fetch per chunk

        for start in range(0, len(images), bs):
            chunk = images[start:start + bs]
            metas = metadata[start:start + bs] if metadata else None
            opts = per_sample[start:start + bs]
            pixels = preprocess_image_batch(chunk, self.config)
            aux = preprocess_metadata_batch(metas, len(chunk), self.config)
            for i, o in enumerate(opts):
                if o is not None and o.aux_override is not None:
                    aux[i] = np.asarray(o.aux_override, np.float32)
            n = len(chunk)
            bucket = self._bucket(n)
            if n < bucket:
                pixels = np.concatenate(
                    [pixels, np.zeros((bucket - n,) + pixels.shape[1:], pixels.dtype)])
                aux = np.concatenate(
                    [aux, np.zeros((bucket - n,) + aux.shape[1:], aux.dtype)])
            # k covers the largest per-sample request, rounded up from the
            # default by doubling, so few distinct k values occur
            want_k = max([default_k] + [o.top_k for o in opts if o is not None and o.top_k])
            k = default_k
            while k < want_k:
                k *= 2
            k = min(k, max(self._n_classes))
            while len(dispatched) >= _MAX_INFLIGHT_CHUNKS:
                drain_oldest()
            out = self._forward(
                torch.from_numpy(pixels).to(self.device, non_blocking=True),
                torch.from_numpy(aux).to(self.device, non_blocking=True), int(k),
            )
            dispatched.append((out, n, opts, k))

        def finish() -> list[HierarchicalClassificationResult]:
            while dispatched:
                drain_oldest()
            results = []
            for packed, opts, k in completed:
                for row, o in zip(packed, opts):
                    top_k = o.top_k if (o is not None and o.top_k) else default_k
                    results.append(self._build_result(row, min(top_k, k)))
            return results

        return finish

    def _build_result(self, packed_row: np.ndarray, top_k: int) -> HierarchicalClassificationResult:
        """packed_row: (2 * n_tasks, k), per task its values row then its
        indices row."""
        tasks = []
        for ti, (task, n_t) in enumerate(zip(self.task_keys, self._n_classes)):
            rank = rank_level_from_task_key(task)
            vals = packed_row[2 * ti]
            idx = packed_row[2 * ti + 1]
            k = min(top_k, n_t)
            idx_map = self.class_maps.idx_to_taxon_id.get(rank, {})
            preds = [
                (int(idx_map.get(int(ci), int(ci))), float(v))
                for v, ci in zip(vals[:k], idx[:k])
            ]
            tasks.append(TaskPrediction(rank_level=rank, task_key=task, predictions=preds))
        if self.taxonomy is not None:
            context = {"source": self.taxonomy.source, "version": self.taxonomy.version,
                       "root": self.taxonomy.root_id}
        else:
            tax = self.config.taxonomy_data
            context = {"source": tax.source_name, "version": tax.version,
                       "root": tax.root_identifier}
        result = HierarchicalClassificationResult(taxonomy_context=context, tasks=tasks)
        if self.config.inference_options.enable_hierarchical_consistency_check:
            result = enforce_hierarchical_consistency(result, self.taxonomy, self.class_maps)
        return result

    def info(self) -> ModelInformation:
        mc = self.config.metadata_preprocessing
        return ModelInformation(
            handler_version=self.config.inference_options.handler_version,
            architecture_name=self.config.model.architecture_name,
            model_description=self.config.model_description,
            task_keys=self.task_keys,
            num_classes_per_task=list(self.config.model.num_classes_per_task),
            input_image_size=list(self.config.input_preprocessing.image_size),
            metadata_components={
                "temporal": mc.use_temporal,
                "geolocation": mc.use_geolocation,
                "elevation": mc.use_elevation,
            },
            taxonomy_source=self.config.taxonomy_data.source_name,
            default_top_k=self.config.inference_options.default_top_k,
        )
