"""Configuration dataclasses mirroring the reference parameter objects.

Defaults are the *effective CLI defaults* of the reference binary (the
boost::program_options defaults in DInDel.cpp:4117-4174 as applied by
getParameters, DInDel.cpp:3907-3989), which override some of the in-class
defaults of DetInDel::Parameters (DInDel.hpp:198-245) and
ObservationModelParameters (ObservationModel.hpp:39-64).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ObservationModelParameters:
    """Pair-HMM observation-model tunables (ObservationModel.hpp:28-99)."""

    model_type: str = "probabilistic"
    p_error: float = 5e-4            # CLI --pError default (DInDel.cpp:4154)
    base_qual_threshold: float = 0.995
    fixed_base_qual: float = 0.99
    max_length_indel: int = 5        # CLI --maxLengthIndel (DInDel.cpp:4157)
    map_qual_threshold: float = 100.0  # capMapQualThreshold (DInDel.cpp:4130)
    cap_map_qual_fast: float = 45.0
    scale_err: float = 0.95
    num_e: int = 3
    p_mut: float = 1e-5              # CLI --pMut (DInDel.cpp:4156)
    min_overlap: int = 0
    num_indels: int = 1
    indel_dist: str = "exponential"
    max_length_del: int = 5          # = max_length_indel (DInDel.cpp:3943)
    p_first_g_lo: float = 0.01
    check_base_qual_threshold: float = 0.95
    b_mid: int = -1
    force_read_on_haplotype: bool = False
    map_unmapped_reads: bool = False
    pad_cover: int = 2               # CLI --flankRefSeq default 2 (DInDel.cpp:4122,3948)
    max_mismatch: int = 2            # CLI --flankMaxMismatch default 2 (DInDel.cpp:4123,3949)
    max_try_hash: int = 5


@dataclass
class Parameters:
    """Window-engine + inference tunables (DInDel.hpp:190-364)."""

    tid: str = "1"
    file_name: str = "output"
    # --- general algorithm (CLI defaults DInDel.cpp:4117-4139) ---
    width: int = 60
    max_hap: int = 8
    max_reads: int = 10000
    map_qual_threshold: float = 0.99
    skip_max_hap: int = 200
    min_read_overlap: int = 20
    max_read_length: int = 500
    max_hap_read_prod: int = 10_000_000
    prior_snp: float = 1.0 / 1000.0
    prior_indel: float = 1.0 / 10000.0
    check_all_cigars: int = 1
    change_ins_to_n: bool = False
    no_indel_window: int = -1
    # --- pooled/EM (DInDel.cpp:4140-4143) ---
    bayes_a0: float = 0.001
    bayes_type: str = "singlevariant"
    em_tol: float = 1e-4
    # --- mode switches ---
    do_diploid: bool = False
    estimate_hap_freqs: bool = False   # --doPooled
    slower: bool = True                # not --faster
    filter_haplotypes: bool = False
    map_unmapped_reads: bool = False
    output_glf: bool = True
    output_realigned_bam: bool = False
    process_realigned_bam: str = "no"
    output_pooled_likelihoods: bool = False
    var_file_is_one_based: bool = False
    quiet: bool = True
    filter_read_aux: str = ""
    inference_method: str = "empirical"
    min_count: int = 1
    # --- misc from in-class defaults ---
    glf_num_hap: int = 5
    num_output_top_hap: int = 5
    fast_width: int = 4
    fast_width_overlap: int = 4
    analyze_low_freq: bool = False
    analyze_low_freq_diff_threshold: float = 0.5
    show_hap_dist: bool = False
    show_cand_hap: bool = False
    show_reads: bool = False
    show_hap_alignments: bool = False
    print_calls_only: bool = False
    ref_file_name: str = ""
    align_against_reference: bool = True
    obs_params: ObservationModelParameters = field(default_factory=ObservationModelParameters)


# Parameters used for aligning candidate haplotypes against the reference
# window (DInDel.cpp:1442-1447): pError=1e-4, pMut=0.01, maxLengthDel=50,
# forceReadOnHaplotype, bMid=0.
def hap_align_params() -> ObservationModelParameters:
    p = ObservationModelParameters()
    p.p_error = 1e-4
    p.p_mut = 0.01
    p.max_length_del = 50
    p.force_read_on_haplotype = True
    p.b_mid = 0
    return p


# Needleman-Wunsch scores used for haplotype<->reference alignment
# (DInDel.cpp:1436, GetCandidates.cpp:109): SeqAn Score<int>(match, mismatch,
# gapExtend, gapOpen).
NW_MATCH = -1
NW_MISMATCH = -460
NW_GAP_EXTEND = -100
NW_GAP_OPEN = -960
