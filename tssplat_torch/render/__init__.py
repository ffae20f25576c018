from .pipeline import MeshRasterizer, RenderOutput, render_views

__all__ = ["MeshRasterizer", "RenderOutput", "render_views"]
