"""VCF support (reference parity: ``impl/formats/vcf/``)."""
