#!/usr/bin/env bash
# End-to-end example mirroring the reference's example/example.sh:
# build an LD schema from PLINK genotypes, fit the model, and (optionally)
# verify against the reference's committed golden output.
#
# Usage: examples/run_example.sh [DATA_DIR] [OUT_DIR]
#   DATA_DIR: a directory shaped like the reference's example/ folder
#             (default: /root/reference/example)
#   OUT_DIR:  where to write the schema + fit outputs (default: ./example_out)
set -euo pipefail

DATA_DIR=${1:-/root/reference/example}
OUT_DIR=${2:-example_out}
mkdir -p "$OUT_DIR/ld_mat"

# 1. Build the block LD matrix from genotype data
python -m vilma_tpu.frontend make_ld_schema --logfile - \
    --out-root "$OUT_DIR/ld_mat/example_schema" \
    --extract "$DATA_DIR/keep_variants.txt" \
    --block-file "$DATA_DIR/blockfile.bed" \
    --plink-file-list "$DATA_DIR/plink_file_list.txt" \
    --ldthresh 0.8

# 2. Fit the model (K=81 mixture components, learned SE scaling).
# --precision f64 pins the parity path: this example exists to
# demonstrate 1e-6-level agreement with the reference golden, which the
# f32 fast path (the default on a GPU) does not target.
python -m vilma_tpu.frontend fit --logfile - \
    --precision f64 \
    --sumstats "$DATA_DIR/example_data/example_gwas_sumstats.txt" \
    --output "$OUT_DIR/example_vilma_run" \
    --ld-schema "$OUT_DIR/ld_mat/example_schema.schema" \
    --seed 42 -K 81 --init-hg 0.2 --samplesizes 300e3 \
    --names ukbb --learn-scaling \
    --extract "$DATA_DIR/keep_variants.txt"

echo "PGS weights written to $OUT_DIR/example_vilma_run.estimates.tsv"

# 3. Verify against the reference's committed golden output when present
GOLD="$DATA_DIR/copy_of_example_vilma_run.estimates.tsv"
if [[ -f "$GOLD" ]]; then
    python - "$OUT_DIR/example_vilma_run.estimates.tsv" "$GOLD" <<'EOF'
import sys
import numpy as np
import pandas as pd
mine = pd.read_csv(sys.argv[1], sep='\t')
gold = pd.read_csv(sys.argv[2], sep='\t')
for col in ['posterior_ukbb', 'posterior_variance_ukbb']:
    err = np.max(np.abs(mine[col] - gold[col]) / np.abs(gold[col]))
    print(f'{col}: max relative error vs reference golden = {err:.2e}')
    assert err < 1e-6
print('MATCHES REFERENCE GOLDEN')
EOF
fi
