"""The serving path's host-side pieces: the micro-batcher and the web QA
frontend."""

from .batcher import MicroBatcher
from .webapp import QAWebApp, serve
