"""Pipeline stages and named run configurations.

Stage methods mirror the reference ``Pipeline``
(reference src/pipeline.py:103-331) over the TPU-native components;
``RunConfig`` carries the same flags (reference :45-62) extended with the
retrieval-method knobs; the named-config registry mirrors the reference's
13 presets (reference :476-488) with their provider/model/flag choices —
the IBM entries are kept for parity but route through the OpenAI-compatible
client (the original contest proxy is long gone).

Port of ``rag_challenge_2_tpu/pipeline/run.py``: the same ``RunConfig``,
stages and presets over the port's ingestion, index, engine and encoder,
on ``device`` (the card unless the caller names another).  One departure
until the port can train the encoder: where the JAX package pretrains an
encoder on the corpus before its first index build, the port raises
(:func:`no_pretraining`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from ..device import DeviceLike, resolve_device
from ..index import load_index
from ..ingestion import (
    CorpusIngestor,
    PageTextPreparation,
    TableSerializer,
    TextSplitter,
    get_parser,
)
from ..llm import LLMFacade, LLMReranker, get_provider
from ..qa import QAConfig, QuestionsProcessor
from ..retrieval.engine import QueryEngine
from .paths import PipelineConfig, next_available_filename


@dataclasses.dataclass
class RunConfig:
    use_serialized_tables: bool = False
    parent_document_retrieval: bool = False
    use_vector_dbs: bool = True
    use_bm25_db: bool = False
    # hybrid fusion rule (QAConfig.fuse_mode/dense_weight): "sum" + 0.5
    # is the measured default; "max" + 1.0 = reference scoring parity
    fuse_mode: str = "sum"
    dense_weight: float = 0.5
    llm_reranking: bool = False
    llm_reranking_sample_size: int = 30
    top_n_retrieval: int = 10
    parallel_requests: int = 10
    team_email: str = ""
    submission_name: str = ""
    pipeline_details: str = ""
    submission_file: bool = True
    full_context: bool = False
    api_provider: str = "qwen"
    answering_model: str = "qwen-turbo"
    config_suffix: str = ""
    # retrieval-method extensions (Streamlit-era knobs, reference
    # app_jinpan_qa.py:1528-1857)
    use_hyde: bool = False
    use_multi_query: bool = False
    retrieval_method: str = "basic"
    max_hops: int = 4
    neighbor_k: int = 30
    answer_schema: str = "jingpan"
    use_ivf: bool = False           # cluster the corpus at load, probe-search
    ivf_nprobe: int = 8
    micro_batch: int = 0            # >0: coalesce concurrent same-route
                                    # searches into one vmapped dispatch
                                    # (serving/batcher.MicroBatcher)
    quantize_int8: bool = False     # int8 row store at load: 4× corpus per
                                    # HBM byte (index/store.quantize_index)
    scan_rt: Optional[float] = None  # fast large-corpus scan mode: fused
                                     # PartialReduce at this recall target
                                     # instead of the exact sort (10M-scale
                                     # configs; bench.py measures the cost)
    cluster_order: bool = False     # with use_ivf: rearrange the corpus into
                                    # IVF list order at load — ONE row store
                                    # serves probes + flat paths (halves
                                    # serving HBM; index/ivf
                                    # .cluster_order_index)


class Pipeline:
    def __init__(
        self,
        root_path: Path,
        run_config: Optional[RunConfig] = None,
        embedder: Optional[Callable[[List[str]], np.ndarray]] = None,
        provider=None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.run_config = run_config = run_config or RunConfig()
        self.paths = PipelineConfig(
            root_path,
            serialized=run_config.use_serialized_tables,
            config_suffix=run_config.config_suffix,
        )
        self._embedder = embedder
        self._provider = provider

    # lazy deps --------------------------------------------------------
    @property
    def provider(self):
        if self._provider is None:
            self._provider = get_provider(self.run_config.api_provider)
        return self._provider

    @property
    def embedder(self):
        if self._embedder is None:
            from ..models.encoder import (
                EmbeddingModel, EncoderConfig, from_jax_params, load_params_npz)

            params_path = self.paths.databases_path / "encoder_params.npz"
            params = None
            if params_path.exists():
                # corpus-pretrained weights (the save_params layout)
                params = from_jax_params(load_params_npz(params_path))
                print(f"[encoder] loaded corpus-pretrained params: {params_path}")
            else:
                print("[encoder] using randomly initialized weights "
                      "(run `main.py train-encoder` to pretrain on this corpus)")
            model = EmbeddingModel(EncoderConfig(), params=params,
                                   device=self.device)
            self._embedder = model.embed
        return self._embedder

    @property
    def query_embedder(self):
        """The embedder for the serving path: when the in-repo encoder is
        the embedder, queries stay device-resident end-to-end
        (EmbeddingModel.embed_device → QueryEngine.search), skipping the
        device→host pull + re-upload per question."""
        emb = self.embedder
        owner = getattr(emb, "__self__", None)
        if owner is not None and hasattr(owner, "embed_device"):
            return owner.embed_device
        return emb

    # ingestion stages (reference src/pipeline.py:204,145,153,162,171) --
    def parse_pdf_reports(self, parallel: bool = False, chunk_size: int = 2,
                          max_workers: int = 10, parser: str = "auto") -> None:
        parser = get_parser(self.paths.parsed_reports_path,
                            self.paths.subset_path, kind=parser)
        inputs = sorted(self.paths.pdf_reports_dir.glob("*"))
        inputs = [p for p in inputs if p.suffix.lower() in (".pdf", ".txt")]
        if parallel and hasattr(parser, "parse_and_export_parallel"):
            parser.parse_and_export_parallel(inputs, chunk_size=chunk_size, max_workers=max_workers)
        else:
            parser.parse_and_export(inputs)

    def serialize_tables(self, max_workers: int = 5) -> None:
        TableSerializer(self.provider, max_workers=max_workers).process_directory_parallel(
            self.paths.parsed_reports_path, self.paths.serialized_reports_path
        )

    def merge_reports(self) -> None:
        prep = PageTextPreparation(
            use_serialized_tables=self.run_config.use_serialized_tables
        )
        src = (
            self.paths.serialized_reports_path
            if self.run_config.use_serialized_tables
            and self.paths.serialized_reports_path.exists()
            else self.paths.parsed_reports_path
        )
        prep.process_reports(src, self.paths.merged_reports_path)

    def export_reports_to_markdown(self) -> None:
        PageTextPreparation().export_to_markdown(
            self.paths.merged_reports_path, self.paths.reports_markdown_path
        )

    def chunk_reports(self) -> None:
        TextSplitter().split_all_reports(
            self.paths.merged_reports_path,
            self.paths.documents_dir,
            serialized_tables_dir=(
                self.paths.serialized_reports_path
                if self.run_config.use_serialized_tables
                else None
            ),
        )

    def create_vector_dbs(self) -> None:
        """Chunked reports → one on-device corpus index npz (dense + BM25
        CSR in one artifact — the role of reference :186-202).

        Where no embedder is given and no pretrained encoder params exist,
        the JAX package ICT-pretrains the encoder on this corpus first (a
        production index built on randomly initialized embeddings is a
        silent quality trap).  The port cannot train yet: it raises there
        (:func:`no_pretraining`), unless ``RAGTPU_AUTO_PRETRAIN=0`` asks
        for the random weights."""
        params_path = self.paths.databases_path / "encoder_params.npz"
        if (
            self._embedder is None
            and not params_path.exists()
            and os.environ.get("RAGTPU_AUTO_PRETRAIN", "1") != "0"
        ):
            no_pretraining(f"no encoder params at {params_path}")
        CorpusIngestor(self.embedder, with_sparse=True,
                       device=self.device).process_reports(
            self.paths.documents_dir, self.paths.index_path
        )

    create_bm25_db = create_vector_dbs  # same artifact carries the CSR index

    def process_parsed_reports(self) -> None:
        self.merge_reports()
        self.export_reports_to_markdown()
        self.chunk_reports()
        self.create_vector_dbs()

    # question answering (reference :254-331) ---------------------------
    def build_processor(self) -> QuestionsProcessor:
        idx, meta = load_index(self.paths.index_path, device=self.device)
        rc = self.run_config
        if rc.quantize_int8:
            from ..index.store import quantize_index

            idx = quantize_index(idx)
        qa_cfg = QAConfig(
            schema=rc.answer_schema,
            use_hyde=rc.use_hyde,
            use_multi_query=rc.use_multi_query,
            llm_reranking=rc.llm_reranking,
            llm_reranking_sample_size=rc.llm_reranking_sample_size,
            top_n_retrieval=rc.top_n_retrieval,
            return_parent_pages=rc.parent_document_retrieval,
            retrieval_method=rc.retrieval_method,
            max_hops=rc.max_hops,
            neighbor_k=rc.neighbor_k,
            full_context=rc.full_context,
            use_bm25=rc.use_bm25_db,
            fuse_mode=rc.fuse_mode,
            dense_weight=rc.dense_weight,
            use_ivf=rc.use_ivf,
            ivf_nprobe=rc.ivf_nprobe,
            scan_rt=rc.scan_rt,
            parallel_requests=rc.parallel_requests,
            micro_batch=rc.micro_batch,
            answering_model=rc.answering_model,
        )
        engine = QueryEngine(idx, meta)
        if rc.use_ivf:
            # load the persisted IVF when it matches this exact corpus
            # artifact; otherwise build once and persist (the reference's
            # indexes are written once and loaded forever, src/ingestion.py
            # :92-102 — rebuilding k-means on every start costs ~59 s at 1M)
            from ..index.store import index_fingerprint, load_ivf, save_ivf

            ivf_path = Path(str(self.paths.index_path) + ".ivf.npz")
            fp = index_fingerprint(self.paths.index_path)
            ivf = load_ivf(ivf_path, expect_fingerprint=fp, device=self.device)
            if ivf is not None:
                engine.ivf = ivf
            else:
                # when the IVF buffer will BECOME the store (cluster_order)
                # it must keep the corpus's int8 budget — and the sidecar
                # then persists int8, not a 4x f32 copy
                quant = rc.cluster_order and idx.emb_scale is not None
                save_ivf(ivf_path, engine.build_ivf(quantize=quant or None),
                         fingerprint=fp)
            if rc.cluster_order:
                # probe-served layout: the flat store is dropped after the
                # permute — the IVF's list-ordered buffer is the corpus
                engine = engine.cluster_order()
        return QuestionsProcessor(
            engine,
            self.query_embedder,
            LLMFacade(self.provider),
            LLMReranker(self.provider) if rc.llm_reranking else None,
            qa_cfg,
        )

    def process_questions(self) -> Dict:
        with open(self.paths.questions_file_path, "r", encoding="utf-8") as f:
            questions = json.load(f)
        processor = self.build_processor()
        out_path = next_available_filename(self.paths.answers_file_path)
        rc = self.run_config
        return processor.process_questions_list(
            questions,
            str(out_path),
            submission_file=rc.submission_file,
            team_email=rc.team_email,
            submission_name=rc.submission_name,
            pipeline_details=rc.pipeline_details,
        )


def no_pretraining(why: str) -> None:
    """The port has no encoder pretraining yet (the JAX package's
    ``models/pretrain.py``): stop rather than index with random weights."""
    raise RuntimeError(
        f"{why}, and encoder pretraining is not ported to this package yet "
        "(ROADMAP.md, A.13): pass an embedder, save params with the JAX "
        "package's `main.py train-encoder`, or set RAGTPU_AUTO_PRETRAIN=0 "
        "to index with random encoder weights")


# ---------------------------------------------------------------- presets

def _cfg(**kw) -> RunConfig:
    return RunConfig(**kw)


configs: Dict[str, RunConfig] = {
    "base": _cfg(),
    "pdr": _cfg(parent_document_retrieval=True),
    "max": _cfg(parent_document_retrieval=True, llm_reranking=True,
                use_serialized_tables=True),
    "max_no_ser_tab": _cfg(parent_document_retrieval=True, llm_reranking=True),
    # the reference's best config (reference src/pipeline.py:480)
    "max_nst_o3m": _cfg(parent_document_retrieval=True, llm_reranking=True,
                        api_provider="openai", answering_model="o3-mini-2025-01-31",
                        config_suffix="_max_nst_o3m"),
    "max_st_o3m": _cfg(parent_document_retrieval=True, llm_reranking=True,
                       use_serialized_tables=True, api_provider="openai",
                       answering_model="o3-mini-2025-01-31",
                       config_suffix="_max_st_o3m"),
    "ibm_llama70b": _cfg(parent_document_retrieval=True,
                         answering_model="meta-llama/llama-3-3-70b-instruct",
                         api_provider="openai", config_suffix="_ibm_llama70b"),
    "ibm_llama8b": _cfg(parent_document_retrieval=True,
                        answering_model="meta-llama/llama-3-1-8b-instruct",
                        api_provider="openai", config_suffix="_ibm_llama8b"),
    "gemini_thinking": _cfg(parent_document_retrieval=True, full_context=True,
                            parallel_requests=1, api_provider="gemini",
                            answering_model="gemini-2.0-flash-thinking-exp-01-21",
                            config_suffix="_gemini_thinking_fc"),
    "qwen": _cfg(parent_document_retrieval=True, llm_reranking=True,
                 parallel_requests=4, api_provider="qwen",
                 answering_model="qwen-turbo", config_suffix="_qwen_v2"),
    "qwen_max": _cfg(parent_document_retrieval=True, llm_reranking=True,
                     parallel_requests=4, api_provider="qwen",
                     answering_model="qwen-max-2025-01-25",
                     config_suffix="_qwen_max_v2"),
    "qwen_plus": _cfg(parent_document_retrieval=True, llm_reranking=True,
                      parallel_requests=4, api_provider="qwen",
                      answering_model="qwen-plus-2025-07-28",
                      config_suffix="_qwen_plus_v2"),
    # offline smoke preset (stub provider; used by tests/CI)
    "offline": _cfg(parent_document_retrieval=True, api_provider="stub",
                    answering_model="stub", parallel_requests=1,
                    submission_file=True, config_suffix="_offline"),
    # 10M-row serving preset (BASELINE config 5 scale): int8 row store
    # (10.2 GB for 10M×1024 — the only way the corpus fits one chip),
    # IVF probes over the cluster-ordered store (one buffer for probes +
    # flat paths, Pallas span-fused scoring), and the PartialReduce fast
    # scan for the traversal/exact tiers.  bench.py measures every tier.
    "scale10m": _cfg(parent_document_retrieval=True, quantize_int8=True,
                     use_ivf=True, ivf_nprobe=8, cluster_order=True,
                     scan_rt=0.95, config_suffix="_scale10m"),
}
