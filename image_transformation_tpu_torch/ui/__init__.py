"""The port's user interfaces (counterpart of image_transformation_tpu/ui/): the
Streamlit apps, their headless driver, and the console and web artifact
viewers."""
