from repro_torch.crypto.templates import (KeyedRotation, cosine_scores,
                                          encrypt_bytes, decrypt_bytes,
                                          encrypt_array, decrypt_array)
from repro_torch.crypto.gallery import SecureGallery
