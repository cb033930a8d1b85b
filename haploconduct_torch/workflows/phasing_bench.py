"""Phasing-benchmark conversions (rebuild of benchmarking/*.py).

- `hpop_input_vcf`: strip homozygous calls and non-GT format fields for
  H-PoP input (benchmarking/hpop_input_vcf.py)
- `sdhap_to_phased_vcf`: merge SDhaP/H-PoP phasing output into a VCF,
  adding PS phase-set tags (benchmarking/sdhap2vcf.py, diploid case)
- `phased_vcf_to_contigs`: build per-block haplotype contigs from a phased
  VCF + reference — implemented natively (the reference shells out to
  samtools faidx | bcftools consensus, absent here); substitutions and
  simple indels are applied directly
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple


def hpop_input_vcf(lines: Iterable[str]) -> List[str]:
    out = []
    for line in lines:
        if line.startswith("#"):
            out.append(line)
            continue
        fields = line.rstrip("\n").split("\t")
        fmt = fields[8].split(":")
        gt = fields[9].split(":")[fmt.index("GT")]
        if len(set(gt.replace("|", "/").split("/"))) == 1:
            continue  # homozygous
        out.append("\t".join(fields[0:8] + ["GT", gt]) + "\n")
    return out


def parse_sdhap_blocks(lines: Iterable[str], fmt: str = "sdhap") -> Dict[int, Tuple[str, int]]:
    """SDhaP/H-PoP phasing output -> {variant_index: (phase 'a|b', block)}."""
    idx2phase: Dict[int, Tuple[str, int]] = {}
    block = 0
    for line in lines:
        if line.startswith("B"):
            block += 1
            continue
        if line.startswith("*") or not line.strip():
            continue
        parts = line.rstrip().split("\t")
        idx = int(parts[0])
        if "-" in parts[1:]:
            continue
        if fmt == "sdhap":
            haps = [str(int(x) - 1) for x in parts[1:]]
        else:
            haps = list(parts[1:])
        if max(int(x) for x in haps) >= len(haps):
            continue
        idx2phase[idx] = ("|".join(haps), block)
    return idx2phase


def sdhap_to_phased_vcf(phased_lines: Iterable[str], vcf_lines: Iterable[str],
                        fmt: str = "sdhap") -> List[str]:
    """Diploid case of benchmarking/sdhap2vcf.py."""
    idx2phase = parse_sdhap_blocks(phased_lines, fmt)
    out = []
    idx = -1 if fmt == "sdhap" else 0
    for line in vcf_lines:
        if line.startswith("#"):
            if not line.startswith("##"):
                out.append('##FORMAT=<ID=PS,Number=1,Type=Integer,'
                           'Description="Phase set identifier">\n')
            out.append(line)
            continue
        line = line.rstrip("\n")
        fields = line.split("\t")
        fmt_field = fields[8]
        gt_idx = fmt_field.split(":").index("GT")
        data = fields[9].split(":")
        gt = data[gt_idx]
        gt_set = set(gt.replace("|", "/").split("/"))
        if len(gt_set) == 1 and sum(int(x) for x in gt_set) == 0:
            continue  # hom-ref dropped
        idx += 1
        new_fmt = fmt_field
        if idx in idx2phase:
            phase, block = idx2phase[idx]
            data[gt_idx] = phase
            data.append(str(block))
            new_fmt += ":PS"
        out.append("\t".join(fields[0:8] + [new_fmt, ":".join(data)]) + "\n")
    return out


def phased_vcf_to_contigs(vcf_lines: Iterable[str], ref_seq: str, chrom: str,
                          region: Optional[Tuple[int, int]] = None) -> List[Tuple[str, str]]:
    """Per-phase-set haplotype contigs from a phased VCF (native
    equivalent of benchmarking/phasedvcf2contigs.py). Returns
    [(contig_id, sequence)] with ids '<block>.h1' / '<block>.h2'."""
    variants = []  # (pos1based, ref, alts, hap1_allele, hap2_allele, phase_set)
    for line in vcf_lines:
        if line.startswith("#"):
            continue
        f = line.rstrip("\n").split("\t")
        if f[0] != chrom:
            continue
        fmt = f[8].split(":")
        data = f[9].split(":")
        if "GT" not in fmt:
            continue
        gt = data[fmt.index("GT")]
        if "|" not in gt:
            continue  # unphased
        if "PS" not in fmt:
            continue
        ps = int(data[fmt.index("PS")])
        a1, a2 = (int(x) for x in gt.split("|")[:2])
        alleles = [f[3]] + f[4].split(",")
        variants.append((int(f[1]), f[3], alleles, a1, a2, ps))

    start = region[0] if region else 1
    end = region[1] if region else len(ref_seq)
    variants = [v for v in variants if start <= v[0] <= end]
    # group into blocks by phase set, split reference at block boundaries
    contigs: List[Tuple[str, str]] = []
    blocks: Dict[int, List] = {}
    for v in variants:
        blocks.setdefault(v[5], []).append(v)
    boundaries = sorted(blocks.keys(), key=lambda ps: min(v[0] for v in blocks[ps]))
    segs = []
    pos_old = start
    for ps in boundaries:
        first = min(v[0] for v in blocks[ps])
        if first > pos_old:
            segs.append((pos_old, first - 1, None))
        last_of_block = max(v[0] for v in blocks[ps])
        segs.append((first, last_of_block, ps))
        pos_old = last_of_block + 1
    if pos_old <= end:
        segs.append((pos_old, end, None))

    def apply(seq_start: int, seq_end: int, vs, hap: int) -> str:
        out = []
        p = seq_start
        for pos, ref, alleles, a1, a2, _ps in sorted(vs, key=lambda v: v[0]):
            allele_idx = a1 if hap == 1 else a2
            out.append(ref_seq[p - 1:pos - 1])
            out.append(alleles[allele_idx])
            p = pos + len(ref)
        out.append(ref_seq[p - 1:seq_end])
        return "".join(out)

    for block_id, (a, b, ps) in enumerate(segs):
        if ps is None:
            contigs.append((f"{block_id}.h1", ref_seq[a - 1:b]))
        else:
            vs = blocks[ps]
            contigs.append((f"{block_id}.h1", apply(a, b, vs, 1)))
            contigs.append((f"{block_id}.h2", apply(a, b, vs, 2)))
    return contigs
