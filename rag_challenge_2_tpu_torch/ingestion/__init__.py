from .ingestor import CorpusIngestor
from .merging import PageTextPreparation, clean_text
from .pdf import DoclingParser, PlainTextParser, get_parser, normalize_page_sequence
from .splitter import TextSplitter, count_tokens, split_text
from .tables import TableSerializer
