"""HISAT-genotype equivalent: allele typing from read alignments.

Reference: hisat2's hisatgenotype.py (driver: align -> extract
per-locus reads -> typing) and hisatgenotype_locus.py /
hisatgenotype_modules/hisatgenotype_typing_common.py (compatibility-class
EM with SQUAREM acceleration).

Copied verbatim from hisat2_tpu/genotype/__init__.py; only the imports,
and the location of the hisat2 sources in citations, are rewritten.
"""
