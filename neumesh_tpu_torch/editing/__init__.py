"""Scene editing (counterpart of neumesh_tpu/editing/): texture swapping,
texture filling, geometry editing and texture painting."""
from .editable import EditablePrimitive, EditingParams  # noqa: F401
from .texture_model import TextureEditableNeuMesh  # noqa: F401
