"""The benchmark's plain reference of the diploid indel caller.

Frozen copies of the port's pure host code (config, model, variants,
utils, bgzf, bam, fasta, reads, std_sort, hapgen, nw, filterhaps,
diploid, arrays, glf) and of its float64 pair-HMM oracle (oracle.py),
each reduced to its pure-Python path, plus pairhmm.py (the oracle
vectorised over pairs with plain torch operations) and caller.py (the
window loop).  Nothing here imports the program or JAX; the copies
do not change when the program does."""
