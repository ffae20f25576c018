from .pipeline import RenderOutput, render_views

__all__ = ["RenderOutput", "render_views"]
