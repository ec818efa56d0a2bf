"""hloc (hierarchical localization) SfM backend for ``scripts/process_data.py``
(counterpart of ``nerfstudio_tpu/process_data/hloc_utils.py``; reference
nerfstudio/process_data/hloc_utils.py:30).

Learned features and matching, then a pycolmap reconstruction whose sparse
model ``colmap_utils.colmap_to_json`` converts. hloc and pycolmap are
optional and not installed on the card's machine; without them this raises
with the install hint."""

from __future__ import annotations

from pathlib import Path


def hloc_available() -> bool:
    try:
        import hloc  # type: ignore  # noqa: F401
        import pycolmap  # type: ignore  # noqa: F401

        return True
    except ImportError:
        return False


def run_hloc(
    image_dir: Path,
    colmap_dir: Path,
    camera_model: str = "OPENCV",
    matching_method: str = "vocab_tree",
    feature_type: str = "superpoint_aachen",
    matcher_type: str = "superglue",
    num_matched: int = 50,
) -> Path:
    """Feature extraction + matching + reconstruction via the hloc toolbox.

    Returns the sparse-model dir (``colmap_dir/sparse/0``) suitable for
    ``colmap_to_json``. Raises RuntimeError when hloc is not installed.
    """
    if not hloc_available():
        raise RuntimeError(
            "the hloc SfM backend needs the 'hloc' toolbox and 'pycolmap' "
            "(pip install hloc pycolmap); alternatively use the default "
            "COLMAP backend (--sfm-tool colmap)"
        )
    import pycolmap  # type: ignore
    from hloc import (  # type: ignore
        extract_features,
        match_features,
        pairs_from_exhaustive,
        pairs_from_retrieval,
        reconstruction,
    )

    colmap_dir.mkdir(parents=True, exist_ok=True)
    sfm_pairs = colmap_dir / "pairs.txt"
    sfm_dir = colmap_dir / "sparse" / "0"
    features = colmap_dir / "features.h5"
    matches = colmap_dir / "matches.h5"

    feature_conf = extract_features.confs[feature_type]
    matcher_conf = match_features.confs[matcher_type]
    references = sorted(p.relative_to(image_dir).as_posix() for p in image_dir.iterdir() if p.is_file())

    extract_features.main(feature_conf, image_dir, image_list=references, feature_path=features)
    if matching_method == "exhaustive":
        pairs_from_exhaustive.main(sfm_pairs, image_list=references)
    else:
        retrieval_conf = extract_features.confs["netvlad"]
        retrieval_path = extract_features.main(retrieval_conf, image_dir, colmap_dir)
        pairs_from_retrieval.main(retrieval_path, sfm_pairs, num_matched=min(len(references), num_matched))
    match_features.main(matcher_conf, sfm_pairs, features=features, matches=matches)

    image_options = pycolmap.ImageReaderOptions(camera_model=camera_model)
    reconstruction.main(
        sfm_dir,
        image_dir,
        sfm_pairs,
        features,
        matches,
        camera_mode=pycolmap.CameraMode.SINGLE,
        image_options=image_options,
        verbose=False,
    )
    return sfm_dir
