"""The serving path's host-side pieces."""

from .batcher import MicroBatcher
