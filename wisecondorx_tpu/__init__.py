"""wisecondorx_tpu — a JAX shallow-WGS copy-number-aberration engine.

A from-scratch rebuild of the capabilities of WisecondorX
(CenterForMedicalGeneticsGhent/WisecondorX):

* ``convert``  — BAM/CRAM -> per-chromosome binned read counts (native C++
  BGZF/BAM reader; no pysam dependency).
* ``newref``   — N negative-control samples -> normalization reference
  (mask -> depth normalization -> PCA residual -> per-bin K-nearest-neighbour
  "within-sample reference" search -> null ratios -> GMM sex model).  The
  O(bins^2 x samples) neighbour search runs as a tiled device distance
  kernel with running top-k, split over the devices of a host.
* ``predict``  — test sample + reference -> per-bin log2 ratios and z-scores
  -> circular binary segmentation (JAX reimplementation of CBS, replacing the
  reference's R/DNAcopy subprocess) -> aberration calls, BED tables, plots.

Design stance (see SURVEY.md section 7): pure, jittable kernels over dense
arrays — ``counts[bins]`` per sample and ``ref_matrix[bins, samples]`` — plus
a thin CLI preserving the reference's three-stage UX and .npz formats.
"""

__version__ = "0.1.0"

from wisecondorx_tpu.genome import GenomeLayout, MaskedLayout

__all__ = ["GenomeLayout", "MaskedLayout", "__version__"]
