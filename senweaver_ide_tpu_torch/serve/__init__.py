"""serve/ — multi-replica rollout serving fleet.

Composes N :class:`~senweaver_ide_tpu_torch.rollout.engine.RolloutEngine`
instances behind one facade with admission control (priority classes,
rate limits, deadlines, typed :class:`Rejected` sheds), SLO-aware
routing (prefix affinity + least outstanding work + retry-on-death), and
versioned rolling weight publication. See ``docs/serving.md``.
"""

from .admission import (AdmissionConfig, AdmissionQueue, ClassPolicy,
                        FleetRequest, INTERACTIVE, PRIORITY_CLASSES,
                        REJECT_DEADLINE, REJECT_NO_REPLICAS,
                        REJECT_QUEUE_FULL, REJECT_RATE_LIMITED,
                        REJECT_REPLICA_FAILURE, Rejected,
                        RequestRejected, TRAIN_ROLLOUT, TokenBucket)
from .autoscale import (ACTION_ADD, ACTION_DRAIN, AutoscaleConfig,
                        AutoscaleController)
from .frontend import Completed, ServingFleet
from .learner import (EpisodeStreamer, ExperienceClient,
                      FleetPublishClient, LearnerConfig,
                      LearnerPublishError, LearnerService,
                      StreamingLearnerConfig, StreamingLearnerService)
from .learner_server import (ExperienceRpcHandler, FleetRpcHandler,
                             LeaseRpcHandler, RemoteLeaseStore,
                             serve_experience_http, serve_fleet_http,
                             serve_lease_http)
from .prefix_store import SharedPrefixStore
from .remote import (PROBE_DEAD, PROBE_OK, PROBE_SLOW,
                     RemoteEngineClient, RemoteReplica)
from .remote_server import (EngineRpcHandler, RpcHandlerBase,
                            serve_engine_http, serve_rpc_http)
from .replica import (DEAD, DRAINING, EngineReplica, LIVE, ReplicaDead)
from .router import Router
from .rpc import (HttpTransport, LoopbackTransport, RpcApplicationError,
                  RpcCircuitOpen, RpcError, RpcProtocolError,
                  RpcServerError, RpcTimeout, RpcTransportError)
from .weights import StalePublishError, WeightPublisher

__all__ = [
    "ACTION_ADD", "ACTION_DRAIN",
    "AdmissionConfig", "AdmissionQueue", "AutoscaleConfig",
    "AutoscaleController", "ClassPolicy", "Completed",
    "DEAD", "DRAINING", "EngineReplica", "EngineRpcHandler",
    "EpisodeStreamer", "ExperienceClient", "ExperienceRpcHandler",
    "FleetPublishClient", "FleetRequest", "FleetRpcHandler",
    "HttpTransport", "INTERACTIVE",
    "LIVE", "LearnerConfig", "LearnerPublishError", "LearnerService",
    "LeaseRpcHandler", "LoopbackTransport", "PRIORITY_CLASSES",
    "PROBE_DEAD", "PROBE_OK", "PROBE_SLOW",
    "REJECT_DEADLINE", "REJECT_NO_REPLICAS",
    "REJECT_QUEUE_FULL", "REJECT_RATE_LIMITED", "REJECT_REPLICA_FAILURE",
    "Rejected", "RemoteEngineClient", "RemoteLeaseStore", "RemoteReplica",
    "ReplicaDead",
    "RequestRejected", "Router", "RpcApplicationError", "RpcCircuitOpen",
    "RpcError", "RpcHandlerBase", "RpcProtocolError", "RpcServerError",
    "RpcTimeout", "RpcTransportError", "ServingFleet",
    "SharedPrefixStore", "StalePublishError",
    "StreamingLearnerConfig", "StreamingLearnerService",
    "TRAIN_ROLLOUT", "TokenBucket", "WeightPublisher",
    "serve_engine_http", "serve_experience_http", "serve_fleet_http",
    "serve_lease_http", "serve_rpc_http",
]
