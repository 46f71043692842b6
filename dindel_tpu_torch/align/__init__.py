from .nw import gotoh_align, align_haplotype_to_ref  # noqa: F401
