"""Brute-force reference k-mer counter used to validate both the file-format
codecs (against oracle-produced goldens) and the device pipeline.

Intentionally simple and independent of fastk_tpu's compute path.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_COMP = {"a": "t", "c": "g", "g": "c", "t": "a"}


def parse_fasta(path: str) -> List[str]:
    """Raw (case-preserving) read strings; case folding happens downstream,
    after optional homopolymer compression, exactly like the reference."""
    reads, cur = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if cur:
                    reads.append("".join(cur))
                    cur = []
            else:
                cur.append(line)
    if cur:
        reads.append("".join(cur))
    return reads


def parse_fastq(path: str) -> List[str]:
    reads = []
    with open(path) as f:
        lines = f.read().splitlines()
    for i in range(0, len(lines), 4):
        reads.append(lines[i + 1])
    return reads


def parse_reads(path: str) -> List[str]:
    if path.endswith((".fastq", ".fq")):
        return parse_fastq(path)
    return parse_fasta(path)


def revcomp(s: str) -> str:
    return "".join(_COMP[c] for c in reversed(s))


def canonical(s: str) -> str:
    r = revcomp(s)
    return s if s <= r else r


def homopoly_compress(s: str) -> str:
    """-c option semantics: drop a char equal to the previous RAW char, i.e.
    case-sensitively, before any case folding (reference: the ADD macro
    io.c:557-570 compares raw input chars; homo_compress io.c:284-294)."""
    out = [s[0]] if s else []
    for c in s[1:]:
        if c != out[-1]:
            out.append(c)
    return "".join(out)


def count_kmers(reads: List[str], k: int, hc: bool = False) -> Dict[str, int]:
    table: Dict[str, int] = {}
    for r in reads:
        if hc:
            r = homopoly_compress(r)
        r = r.lower()
        for i in range(len(r) - k + 1):
            s = r[i: i + k]
            if any(c not in "acgt" for c in s):
                continue
            c = canonical(s)
            table[c] = table.get(c, 0) + 1
    return table


def profiles_of(reads: List[str], k: int, table: Dict[str, int],
                hc: bool = False) -> List[np.ndarray]:
    """Per-read count profiles, 0 at positions whose k-mer contains non-acgt.
    Counts are clipped at 32767 like the on-disk tables."""
    profs = []
    for r in reads:
        if hc:
            r = homopoly_compress(r)
        r = r.lower()
        n = max(0, len(r) - k + 1)
        p = np.zeros(n, dtype=np.uint16)
        for i in range(n):
            s = r[i: i + k]
            if any(c not in "acgt" for c in s):
                continue
            p[i] = min(table.get(canonical(s), 0), 32767)
        profs.append(p)
    return profs


def sorted_table(table: Dict[str, int], minval: int = 1) -> Tuple[List[str], List[int]]:
    items = sorted((k, min(v, 32767)) for k, v in table.items() if min(v, 32767) >= minval)
    return [k for k, _ in items], [v for _, v in items]
