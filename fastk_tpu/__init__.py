"""fastk_tpu — an accelerator k-mer counting framework with FastK's
capabilities.

A brand-new implementation (not a port) of the capabilities of
thegenemyers/FASTK: canonical k-mer frequency histograms (``.hist``), sorted
k-mer/count tables (``.ktab``) and per-read compressed count profiles
(``.prof``/``.pidx``), with the counting on the device through JAX/XLA.
The compile cache rule lives in :mod:`fastk_tpu.jaxenv`.

Public API mirrors the reference library surface (reference: libfastk.h:30-119):

- :class:`fastk_tpu.formats.hist.Histogram`
- :class:`fastk_tpu.formats.ktab.KmerTable` / :class:`fastk_tpu.formats.ktab.KmerStream`
- :class:`fastk_tpu.formats.prof.ProfileIndex`
- :func:`fastk_tpu.pipeline.count.count_fasta` — the end-to-end counting pipeline.
"""

from fastk_tpu._version import __version__

from fastk_tpu.formats.hist import Histogram, read_histogram, write_histogram
from fastk_tpu.formats.ktab import (
    KmerTable,
    KmerStream,
    read_ktab,
    write_ktab,
)
from fastk_tpu.formats.prof import (
    ProfileIndex,
    encode_profile,
    decode_profile,
    read_profiles,
    write_prof,
)

def __getattr__(name):
    # lazy: the pipeline pulls in jax; the format codecs above do not
    if name == "count_files":
        from fastk_tpu.pipeline.count import count_files

        return count_files
    if name == "count_files_sharded":
        from fastk_tpu.parallel.host import count_files_sharded

        return count_files_sharded
    if name == "count_files_mesh":
        from fastk_tpu.parallel.meshooc import count_files_mesh

        return count_files_mesh
    raise AttributeError(name)


__all__ = [
    "__version__",
    "count_files",
    "count_files_sharded",
    "count_files_mesh",
    "Histogram",
    "read_histogram",
    "write_histogram",
    "KmerTable",
    "KmerStream",
    "read_ktab",
    "write_ktab",
    "ProfileIndex",
    "encode_profile",
    "decode_profile",
    "read_profiles",
    "write_prof",
]
