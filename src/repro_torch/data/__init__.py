from .replay import ReplayableStream, indexed_classification_stream
from .synthetic import synthetic_classification
