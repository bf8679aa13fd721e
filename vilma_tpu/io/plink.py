"""PLINK 1.9 .bed/.bim/.fam reading.

Replaces the reference's libplinkio dependency
(reference make_ld_schema.py:6,101,173-175): .bim/.fam metadata is parsed
as plain text, and the 2-bit SNP-major genotype matrix is decoded by the
native C++ extension (csrc/plinkbed.cpp) with a pure-numpy fallback.

Genotype convention matches libplinkio: 0 = hom first allele (bim allele1),
1 = het, 2 = hom second allele, 3 = missing.
"""
import ctypes
import logging
import os
import subprocess
from dataclasses import dataclass, field

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), 'csrc')
_LIB_PATH = os.path.join(_CSRC, 'libplinkbed.so')


def _load_native():
    """Load (building if necessary) the native bed decoder.

    make is always invoked (it is incremental), so edits to
    csrc/plinkbed.cpp can never silently leave a stale .so in use."""
    try:
        subprocess.run(['make', '-C', _CSRC], check=True,
                       capture_output=True)
    except Exception:  # no toolchain: reuse an existing build or fall back
        pass
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.plinkbed_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int8)]
        lib.plinkbed_decode.restype = ctypes.c_int
        return lib
    except OSError:
        return None


_NATIVE = None
_NATIVE_TRIED = False


def _native():
    global _NATIVE, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE = _load_native()
        _NATIVE_TRIED = True
        if _NATIVE is None:
            logging.warning('native plinkbed decoder unavailable; using '
                            'numpy fallback')
    return _NATIVE


# bed 2-bit code -> genotype, vectorized (00->0, 01->3, 10->1, 11->2)
_CODE_TO_GENO = np.array([0, 3, 1, 2], dtype=np.int8)


@dataclass
class Locus:
    """One .bim row (libplinkio Locus-compatible field names,
    reference make_ld_schema.py:101-135)."""
    chromosome: str
    name: str
    position: float       # genetic distance (cM)
    bp_position: int
    allele1: str
    allele2: str


@dataclass
class PlinkFile:
    """An opened PLINK fileset: loci metadata + genotype row iterator."""
    basename: str
    loci: list = field(default_factory=list)
    num_samples: int = 0
    _genotypes: np.ndarray = None   # [num_snps, num_samples] int8

    def get_loci(self):
        return self.loci

    def __iter__(self):
        return iter(self._genotypes)


def open_plink(basename):
    """Open basename{.bed,.bim,.fam}, decoding all genotypes."""
    basename = str(basename)
    with open(basename + '.bim') as fh:
        bim = [line.split() for line in fh if line.split()]
    with open(basename + '.fam') as fh:
        num_samples = sum(1 for line in fh if line.split())
    num_snps = len(bim)

    genotypes = decode_bed(basename + '.bed', num_samples, num_snps)
    loci = [Locus(chromosome=chrom, name=name, position=float(cm),
                  bp_position=int(bp), allele1=a1, allele2=a2)
            for chrom, name, cm, bp, a1, a2 in bim]
    return PlinkFile(basename=basename, loci=loci,
                     num_samples=num_samples, _genotypes=genotypes)


def decode_bed(bed_path, num_samples, num_snps):
    """Decode a SNP-major .bed into an int8 [num_snps, num_samples]."""
    lib = _native()
    if lib is not None:
        out = np.empty((num_snps, num_samples), dtype=np.int8)
        rc = lib.plinkbed_decode(
            bed_path.encode(), num_samples, num_snps,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        if rc == 0:
            return out
        if rc == -2:
            raise ValueError(f'{bed_path} is not a SNP-major PLINK .bed '
                             'file')
        if rc == -3:
            raise ValueError(f'{bed_path} is truncated')
        raise OSError(f'cannot read {bed_path}')
    return _decode_bed_numpy(bed_path, num_samples, num_snps)


def _decode_bed_numpy(bed_path, num_samples, num_snps):
    raw = np.fromfile(bed_path, dtype=np.uint8)
    if raw.size < 3 or raw[0] != 0x6c or raw[1] != 0x1b or raw[2] != 0x01:
        raise ValueError(f'{bed_path} is not a SNP-major PLINK .bed file')
    bytes_per_snp = (num_samples + 3) // 4
    body = raw[3:]
    if body.size < bytes_per_snp * num_snps:
        raise ValueError(f'{bed_path} is truncated')
    body = body[:bytes_per_snp * num_snps].reshape(num_snps, bytes_per_snp)
    # expand 2-bit codes, little-endian within each byte
    codes = np.stack([(body >> shift) & 3 for shift in (0, 2, 4, 6)],
                     axis=-1).reshape(num_snps, -1)[:, :num_samples]
    return _CODE_TO_GENO[codes]
