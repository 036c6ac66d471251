"""The taxonomic hierarchy."""

from .tree import TaxonomyTree  # noqa: F401
