"""DataFrame persistence codecs.

The universal intermediate format of the pipeline is a compressed npz holding
``data``, ``index`` and ``columns`` arrays (same on-disk contract as the
reference, cnmf.py:31-40), plus tab-separated text for user-facing outputs
(reference cnmf.py:34-35).
"""

import errno
import os

import numpy as np
import pandas as pd


def save_df_to_npz(obj: pd.DataFrame, filename: str):
    """Write atomically (temp file + rename) and return the written file's
    ``(st_mtime_ns, st_size)``, captured from the open file descriptor.

    Atomicity means concurrent readers never see a half-written npz, and the
    returned stat is guaranteed to describe THIS write even if another
    process rewrites the path immediately afterwards (rename preserves
    mtime/size) — the pipeline's artifact memo keys on it."""
    # uncompressed unless CNMF_TPU_COMPRESS=1 (cnmf_tpu/io/dataframe.py:
    # 14-18): zlib on hundreds of spectra files costs more wall than the
    # disk it saves, and np.load reads either form
    writer = (np.savez_compressed
              if os.environ.get("CNMF_TPU_COMPRESS", "0") == "1" else np.savez)
    tmp = f"{filename}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            writer(
                f,
                data=obj.values,
                index=obj.index.values,
                columns=obj.columns.values,
            )
            f.flush()
            st = os.fstat(f.fileno())
        os.replace(tmp, filename)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return (st.st_mtime_ns, st.st_size)


def load_df_from_npz(filename: str) -> pd.DataFrame:
    with np.load(filename, allow_pickle=True) as f:
        # copy=False: the arrays are freshly materialized by np.load and
        # owned by nobody else — letting pandas re-copy a counts matrix
        # doubles the load time of multi-hundred-MB inputs
        obj = pd.DataFrame(
            f["data"], index=f["index"], columns=f["columns"], copy=False
        )
    return obj


def save_df_to_text(obj: pd.DataFrame, filename: str) -> None:
    obj.to_csv(filename, sep="\t")


def load_df_from_text(filename: str) -> pd.DataFrame:
    return pd.read_csv(filename, sep="\t", index_col=0)


def check_dir_exists(path: str) -> None:
    """mkdir -p semantics (reference cnmf.py:42-50)."""
    try:
        os.makedirs(path)
    except OSError as exception:
        if exception.errno != errno.EEXIST:
            raise
