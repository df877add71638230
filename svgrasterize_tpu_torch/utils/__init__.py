from .buckets import bucket_dim, bucket_count, pad_rows
from .constants import EPSILON, FLOAT, FLOAT_RE
