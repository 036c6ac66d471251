"""Parallel image-file existence verification (hybrid datasets).

Copy of linnaeus_tpu/data/image_verifier.py (held against the original by
tests/test_torch_data_pipeline.py).

Reference parity: h5data/image_verifier.py:16-180 — pre-training check of
the image directory against the label file's identifiers with max-missing
thresholds (DATA.HYBRID.VERIFY_IMAGES).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

from linnaeus_tpu_torch.utils.logging import get_h5data_logger

logger = get_h5data_logger()


class ImageVerifier:
    def __init__(
        self,
        images_dir: str,
        file_extension: str = ".jpg",
        num_workers: int = 8,
        chunk_size: int = 1000,
        max_missing_ratio: float = 0.0,
        max_missing_count: int = 0,
        log_missing: bool = True,
    ):
        self.images_dir = images_dir
        self.ext = file_extension
        self.num_workers = max(num_workers, 1)
        self.chunk_size = max(chunk_size, 1)
        self.max_missing_ratio = max_missing_ratio
        self.max_missing_count = max_missing_count
        self.log_missing = log_missing

    def _path(self, identifier: str) -> str:
        if not identifier.endswith(self.ext):
            identifier = identifier + self.ext
        return os.path.join(self.images_dir, identifier)

    def verify_images(
        self, identifiers: list[str]
    ) -> tuple[set[int], list[str]]:
        """Returns (missing_indices, missing_identifiers). Raises RuntimeError
        if thresholds are exceeded."""

        def check_chunk(start: int) -> list[int]:
            end = min(start + self.chunk_size, len(identifiers))
            return [
                i for i in range(start, end)
                if not os.path.exists(self._path(identifiers[i]))
            ]

        starts = range(0, len(identifiers), self.chunk_size)
        missing: list[int] = []
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for chunk_missing in pool.map(check_chunk, starts):
                missing.extend(chunk_missing)

        missing_ids = [identifiers[i] for i in missing]
        n = max(len(identifiers), 1)
        ratio = len(missing) / n
        if missing and self.log_missing:
            logger.warning(
                f"ImageVerifier: {len(missing)}/{n} missing "
                f"({ratio:.2%}); first: {missing_ids[:50]}"
            )
        # reference semantics (vectorized_dataset_processor.py:326-337):
        # a threshold of 0 is DISABLED; exceeding either enabled threshold
        # aborts
        count_exceeded = (
            self.max_missing_count > 0 and len(missing) > self.max_missing_count
        )
        ratio_exceeded = (
            self.max_missing_ratio > 0 and ratio > self.max_missing_ratio
        )
        if count_exceeded or ratio_exceeded:
            raise RuntimeError(
                f"Too many missing images: {len(missing)} ({ratio:.2%}) "
                f"(max count {self.max_missing_count}, "
                f"max ratio {self.max_missing_ratio})"
            )
        return set(missing), missing_ids
