"""Field functions and the serving render_frame."""
