from .bus import (
    CommWorld, CommDomain, InstanceComm, GmemSegment,
    RING_CAPACITY, PAYLOAD_CAP, MAX_INSTANCES, MAX_CHANNELS,
)
