"""Weight conversion between the JAX package's trees and the port."""
