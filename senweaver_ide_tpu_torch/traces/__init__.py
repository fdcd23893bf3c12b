from .schema import (ChatMode, Feedback, Span, SpanData, SpanType, ToolNameStats,
                     Trace, TraceSummary, make_trace, new_id, preview,
                     CONTENT_PREVIEW_CHARS, MAX_TRACES, MAX_SPANS_PER_TRACE)
from .collector import TraceCollector
from .store import TraceStore, export_data
from .features import (N_FEATURES, FEATURE_NAMES, trace_features, batch_features)
from .uploader import TraceUploader, UPLOAD_BATCH_SIZE
