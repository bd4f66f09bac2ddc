"""Dataset acquisition: the UCI-HAR and Opportunity zips (counterpart of
`vmlmf_tpu.data.download`).

`download` fetches a zip with urllib where it is not on disk yet, and
raises with the file to place by hand where the network cannot be reached;
the CLIs' ``--synthetic`` runs need no dataset.
"""

from __future__ import annotations

import os
import zipfile

UCI_HAR_URL = (
    "https://archive.ics.uci.edu/ml/machine-learning-databases/00240/"
    "UCI%20HAR%20Dataset.zip"
)
OPPORTUNITY_URL = (
    "https://archive.ics.uci.edu/ml/machine-learning-databases/00226/"
    "OpportunityUCIDataset.zip"
)

DATASETS = {
    "uci": ("UCI HAR Dataset.zip", UCI_HAR_URL),
    "opp": ("OpportunityUCIDataset.zip", OPPORTUNITY_URL),
}


def download(kind: str, dest_dir: str = "./data", *, extract: bool = True) -> str:
    """Fetch one dataset zip (kind: 'uci' | 'opp') into dest_dir.

    Returns the zip path.  If the file already exists it is not re-downloaded.
    Raises RuntimeError with manual instructions when the network is
    unreachable.
    """
    fname, url = DATASETS[kind.lower()]
    os.makedirs(dest_dir, exist_ok=True)
    zip_path = os.path.join(dest_dir, fname)
    if not os.path.exists(zip_path):
        import urllib.request

        try:
            urllib.request.urlretrieve(url, zip_path)  # noqa: S310
        except Exception as e:
            raise RuntimeError(
                f"could not download {url!r} ({e}); place {fname!r} in "
                f"{dest_dir!r} manually, or use the synthetic data path "
                f"(--synthetic on the CLIs)"
            ) from e
    if extract:
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(dest_dir)
    return zip_path


def prepare_opp(dest_dir: str = "./data", out_dir: str = "./data/opp_npy",
                task: str = "gestures", channels: int = 77) -> str:
    """download('opp') + full ETL to X_/y_{train,test}.npy (preprocess.sh).

    channels=77: 2021 challenge pipeline; channels=113: the legacy variant
    (`preprocess_Opportunity.py`, tasks 'gestures'/'locomotion')."""
    from vmlmf_tpu_torch.data.opp_preprocess import generate_npy

    zip_path = download("opp", dest_dir, extract=False)
    return generate_npy(zip_path, out_dir, task=task, channels=channels)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Download + prepare HAR datasets")
    ap.add_argument("kind", choices=["uci", "opp", "all"])
    ap.add_argument("--dest", default="./data")
    ap.add_argument("--task", default="gestures", choices=["gestures", "locomotion"])
    ap.add_argument("--channels", type=int, default=77, choices=[77, 113])
    args = ap.parse_args(argv)
    kinds = ["uci", "opp"] if args.kind == "all" else [args.kind]
    for k in kinds:
        if k == "opp":
            print(prepare_opp(args.dest, task=args.task, channels=args.channels))
        else:
            print(download(k, args.dest))


if __name__ == "__main__":
    main()
