# Policy artifacts: the versioned, serializable product of a profiling run
# (site table + policy + provenance + oracle verdict + warm-start hints)
# and the file-backed registry that moves it between search, serving,
# training, checkpoints, and CI. One registry serves this package and the
# reference package alike.
from repro_torch.artifacts.artifact import (
    PolicyArtifact, ScopeRow, ArtifactSchemaError, SCHEMA_VERSION,
)
from repro_torch.artifacts.registry import (
    Registry, ArtifactRef, parse_ref, default_root,
    load_artifact_file, save_artifact_file,
)

__all__ = [
    "PolicyArtifact", "ScopeRow", "ArtifactSchemaError", "SCHEMA_VERSION",
    "Registry", "ArtifactRef", "parse_ref", "default_root",
    "load_artifact_file", "save_artifact_file",
]
