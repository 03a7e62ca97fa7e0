from .dtypes import DataType, device_dtypes, host_dtypes, pad_values
from .relation import Relation
from .strings import NULL_ID, StringDictionary
from .batch import MIN_CAPACITY, DeviceBatch, HostBatch, bucket_capacity
from .convert import host_batch_from_numpy
