from .paths import PipelineConfig, next_available_filename
from .run import Pipeline, RunConfig, configs
