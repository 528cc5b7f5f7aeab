from iron_tpu_torch.export.mesh import export_mesh, extract_geometry, write_obj, read_obj
from iron_tpu_torch.export.materials import export_materials, sample_surface
from iron_tpu_torch.export.uv import grid_uv_unwrap
