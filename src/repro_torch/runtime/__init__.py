"""The serving plane: frame store, gallery stores, ``ServingEngine``, the
sharded fleet, the transports, cluster health and the §6 recalibration
loop."""
from repro_torch.runtime.cluster import ElasticMesh, HeartbeatMonitor  # noqa: F401
from repro_torch.runtime.engine import (EngineConfig, QueryState,  # noqa: F401
                                        ServingEngine)
from repro_torch.runtime.fleet import ShardedServingEngine  # noqa: F401
from repro_torch.runtime.gallery import (GalleryStore,  # noqa: F401
                                         LocalGalleryStore,
                                         ShardedGalleryStore)
from repro_torch.runtime.recal import (RecalibrationController,  # noqa: F401
                                       RecalibrationPolicy, match_log_source,
                                       visits_window_source)
from repro_torch.runtime.stream_store import FrameStore  # noqa: F401
from repro_torch.runtime.transport import (FakeRpcTransport,  # noqa: F401
                                           FaultProfile, InProcTransport,
                                           PeerDeadError, PrefetchPipeline,
                                           Transport, manual_clock)
