"""The output-file contract: every artifact path the pipeline reads or writes.

Byte-for-byte the same path templates as the reference's ``paths`` dict
(reference cnmf.py:298-330) so downstream tools (starCAT, notebooks, the R
vignette) can consume this framework's outputs unchanged. Internal artifacts
live in ``output_dir/name/cnmf_tmp/``; user-facing results in
``output_dir/name/``.
"""

import os


def build_paths(output_dir: str, name: str) -> dict:
    tmp = os.path.join(output_dir, name, "cnmf_tmp")
    top = os.path.join(output_dir, name)
    return {
        "normalized_counts": os.path.join(tmp, name + ".norm_counts.h5ad"),
        "nmf_replicate_parameters": os.path.join(tmp, name + ".nmf_params.df.npz"),
        "nmf_run_parameters": os.path.join(tmp, name + ".nmf_idvrun_params.yaml"),
        "nmf_genes_list": os.path.join(top, name + ".overdispersed_genes.txt"),

        "tpm": os.path.join(tmp, name + ".tpm.h5ad"),
        "tpm_stats": os.path.join(tmp, name + ".tpm_stats.df.npz"),

        "iter_spectra": os.path.join(tmp, name + ".spectra.k_%d.iter_%d.df.npz"),
        "iter_usages": os.path.join(tmp, name + ".usages.k_%d.iter_%d.df.npz"),
        "merged_spectra": os.path.join(tmp, name + ".spectra.k_%d.merged.df.npz"),

        "local_density_cache": os.path.join(
            tmp, name + ".local_density_cache.k_%d.merged.df.npz"
        ),
        "consensus_spectra": os.path.join(
            tmp, name + ".spectra.k_%d.dt_%s.consensus.df.npz"
        ),
        "consensus_spectra__txt": os.path.join(
            top, name + ".spectra.k_%d.dt_%s.consensus.txt"
        ),
        "consensus_usages": os.path.join(
            tmp, name + ".usages.k_%d.dt_%s.consensus.df.npz"
        ),
        "consensus_usages__txt": os.path.join(
            top, name + ".usages.k_%d.dt_%s.consensus.txt"
        ),

        "consensus_stats": os.path.join(tmp, name + ".stats.k_%d.dt_%s.df.npz"),

        "clustering_plot": os.path.join(top, name + ".clustering.k_%d.dt_%s.png"),
        "gene_spectra_score": os.path.join(
            tmp, name + ".gene_spectra_score.k_%d.dt_%s.df.npz"
        ),
        "gene_spectra_score__txt": os.path.join(
            top, name + ".gene_spectra_score.k_%d.dt_%s.txt"
        ),
        "gene_spectra_tpm": os.path.join(
            tmp, name + ".gene_spectra_tpm.k_%d.dt_%s.df.npz"
        ),
        "gene_spectra_tpm__txt": os.path.join(
            top, name + ".gene_spectra_tpm.k_%d.dt_%s.txt"
        ),

        "starcat_spectra": os.path.join(
            tmp, name + ".starcat_spectra.k_%d.dt_%s.df.npz"
        ),
        "starcat_spectra__txt": os.path.join(
            top, name + ".starcat_spectra.k_%d.dt_%s.txt"
        ),

        "k_selection_plot": os.path.join(top, name + ".k_selection.png"),
        "k_selection_stats": os.path.join(top, name + ".k_selection_stats.df.npz"),
    }
