"""StyleGAN2 backbone and the triplane generator."""
