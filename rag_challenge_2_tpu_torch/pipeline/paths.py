"""Data-layout schema and artifact conventions.

Mirrors the reference's on-disk contract (reference src/pipeline.py:18-43):
``<root>/pdf_reports`` → ``debug_data/01_parsed_reports`` →
``debug_data/02_merged_reports`` → ``databases/chunked_reports`` →
index artifacts, plus ``subset.csv`` and ``questions.json``.  The
difference: per-document faiss/pkl files become ONE ``corpus_index.npz``
per database root.  The never-overwrite numbered-filename convention
(reference src/pipeline.py:233-252) is kept.

Port of ``rag_challenge_2_tpu/pipeline/paths.py`` (host code:
a copy with the imports pointed at the port).
"""

from __future__ import annotations

from pathlib import Path


class PipelineConfig:
    def __init__(
        self,
        root_path: Path,
        subset_name: str = "subset.csv",
        questions_file_name: str = "questions.json",
        pdf_reports_dir_name: str = "pdf_reports",
        serialized: bool = False,
        config_suffix: str = "",
    ):
        root_path = Path(root_path)
        self.root_path = root_path
        suffix = "_ser_tab" if serialized else ""

        self.subset_path = root_path / subset_name
        self.questions_file_path = root_path / questions_file_name
        self.pdf_reports_dir = root_path / pdf_reports_dir_name

        self.answers_file_path = root_path / f"answers{config_suffix}.json"
        self.debug_data_path = root_path / "debug_data"
        self.databases_path = root_path / f"databases{suffix}"

        self.documents_dir = self.databases_path / "chunked_reports"
        self.index_path = self.databases_path / "corpus_index.npz"
        self.serialized_reports_path = self.debug_data_path / "01_parsed_reports_serialized"

        self.parsed_reports_path = self.debug_data_path / "01_parsed_reports"
        self.merged_reports_path = self.debug_data_path / f"02_merged_reports{suffix}"
        self.reports_markdown_path = self.debug_data_path / f"03_reports_markdown{suffix}"


def next_available_filename(path: Path) -> Path:
    """``answers.json`` → ``answers_01.json`` … never overwrite
    (reference src/pipeline.py:233-252)."""
    path = Path(path)
    if not path.exists():
        return path
    for i in range(1, 100):
        candidate = path.with_name(f"{path.stem}_{i:02d}{path.suffix}")
        if not candidate.exists():
            return candidate
    raise FileExistsError(f"no free filename slot for {path}")
